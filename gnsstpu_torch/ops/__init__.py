"""Device ops of the port: NCOs, correlators, the fused tracking kernel
(K1, CUDA), wire-format unpack and the FFT acquisition cube."""
