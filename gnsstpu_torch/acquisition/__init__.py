"""Acquisition of the port: the FFT code-phase x Doppler search."""
