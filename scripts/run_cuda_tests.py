#!/usr/bin/env python3
"""Run the port's ``cuda``-marked tests on a GPU host that has no jax.

    python3 scripts/run_cuda_tests.py [extra pytest arguments]

The port's test files (and ``tests/conftest.py``) import jax and the JAX
package at the top, to hold the port against the reference on the CPU.
Most ``cuda``-marked tests hold the port's kernels against their plain
PyTorch versions on the card and call nothing of JAX. So this script
stands in an empty module for every ``jax*`` module and every module of
the JAX package (any attribute is a ``MagicMock``), collects
``tests/test_torch_*.py`` and runs ``-m cuda`` only. A test that fails
after calling the stand-in (it compares the card with the JAX package
itself) is reported as skipped, with that reason: it needs jax. On a host
with jax, ``python -m pytest tests/test_torch_*.py -m cuda`` runs them all.
"""

from __future__ import annotations

import importlib.abc
import importlib.machinery
import sys
import types
from pathlib import Path
from unittest import mock

import pytest

REPO = Path(__file__).resolve().parents[1]
_STUBBED = ("jax", "jaxlib", "flax", "optax",
            "distributed_parameter_server_for_ml_training_tpu")


_called = [False]       # a stand-in was called during the current test


class _Mock(mock.MagicMock):
    def __call__(self, *args, **kwargs):
        _called[0] = True
        return super().__call__(*args, **kwargs)


class _Stub(types.ModuleType):
    __path__: list = []     # a package, so submodules resolve here too

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        value = _Mock(name=f"{self.__name__}.{name}")
        setattr(self, name, value)
        return value


class _SkipJaxCallers:
    """Reports a failing test that called the stand-in as skipped."""

    def pytest_runtest_setup(self, item):
        _called[0] = False

    @pytest.hookimpl(hookwrapper=True)
    def pytest_runtest_makereport(self, item, call):
        outcome = yield
        report = outcome.get_result()
        if call.when == "call" and report.failed and _called[0]:
            report.outcome = "skipped"
            report.longrepr = (str(item.path), item.location[1] or 0,
                               "Skipped: calls the JAX package, which this "
                               "host lacks (stubbed)")


class _StubFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _STUBBED:
            return importlib.machinery.ModuleSpec(name, self,
                                                  is_package=True)
        return None

    def create_module(self, spec):
        return _Stub(spec.name)

    def exec_module(self, module):
        pass


def main(argv: list[str]) -> int:
    sys.meta_path.insert(0, _StubFinder())
    sys.path.insert(0, str(REPO))
    files = sorted(str(p) for p in (REPO / "tests").glob("test_torch_*.py"))
    return pytest.main(["-q", "-rs", "-m", "cuda", "-p", "no:cacheprovider",
                        "-p", "no:randomly", "--rootdir", str(REPO),
                        *files, *argv], plugins=[_SkipJaxCallers()])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
