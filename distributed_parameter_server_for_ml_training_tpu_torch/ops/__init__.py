"""Push-codec ops: the NumPy wire codecs, the device codec and kernel K1."""
