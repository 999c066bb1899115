"""PyTorch/CUDA port of the distributed parameter-server training framework.

The JAX package ``distributed_parameter_server_for_ml_training_tpu`` is the
reference; this package re-implements it for an NVIDIA H100, slice by
slice. Ported so far: every registry model (ResNet-18, ResNet-50 with
the ImageNet stem, ViT-B/16, a tiny ViT) under the single-device
baseline, async parameter-server training in one process or over gRPC
with the int8 push codec, whose wire quantize is a CUDA kernel written
for Hopper (``ops/csrc/wire_quantize.cu``), and sync data parallelism
over the worker slots of one card with the int8 reduce-scatter ring,
whose block quantize and dequantize are CUDA kernels too
(``ops/csrc/block_quantize.cu``); and the sequence-parallel ViT over
flash attention kernels (``ops/csrc/flash_attention.cu``). Module names
follow the reference's, so each counterpart is easy to find. The package
imports torch, numpy and the stdlib only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` on a host without a card raises ``RuntimeError``.

    python -m distributed_parameter_server_for_ml_training_tpu_torch.cli \\
        train --mode sync --workers 4 --compression int8 --epochs 1 \\
        --synthetic
"""

__version__ = "0.1.0"
