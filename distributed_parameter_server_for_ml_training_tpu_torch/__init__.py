"""PyTorch/CUDA port of the distributed parameter-server training framework.

The JAX package ``distributed_parameter_server_for_ml_training_tpu`` is the
reference; this package re-implements its main path for an NVIDIA H100:
async parameter-server training of ResNet-18 / CIFAR-100 with the int8
push codec, whose wire quantize is a CUDA kernel written for Hopper
(``ops/csrc/wire_quantize.cu``). Module names follow the reference's, so
each counterpart is easy to find. The package imports torch, numpy and
the stdlib only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` on a host without a card raises ``RuntimeError``.

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \\
        train --mode async --workers 2 --epochs 1 --synthetic
"""

__version__ = "0.1.0"
