#!/usr/bin/env python3
"""Run the port's ``cuda``-marked tests on a GPU host that has no jax.

    python3 scripts/run_cuda_tests.py [extra pytest arguments]

The port's test files (and ``tests/conftest.py``) import jax and the JAX
package at the top, to hold the port against the reference on the CPU.
The ``cuda``-marked tests call nothing of JAX: they hold the port's
kernels against their plain PyTorch versions on the card, and against
the JAX package's outputs read from the committed fixture
``tests/torch_port_jax_reference.npz`` (``tests/test_torch_jax_reference
.py``, whose CPU tests keep it equal to the JAX package). So this script
stands in an empty module for every ``jax*`` module and every module of
the JAX package (any attribute is a ``MagicMock``), collects
``tests/test_torch_*.py`` and runs ``-m cuda`` only. A test that calls a
stand-in gets a mock back and fails. On a host with jax, ``python -m
pytest tests/test_torch_*.py -m cuda`` runs the same tests.
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


class _Stub(types.ModuleType):
    __path__: list = []     # a package, so submodules resolve here too

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        value = mock.MagicMock(name=f"{self.__name__}.{name}")
        setattr(self, name, value)
        return value


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
                        *files, *argv])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
