"""Codec ops: the NumPy wire codecs, the device codec, and kernels K1
(wire quantize) and K2-K4 (block-wise int8 of the sync ring)."""
