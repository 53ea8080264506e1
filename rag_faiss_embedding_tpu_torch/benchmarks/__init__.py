"""The port's counterparts of the benchmark scripts that hold TPU kernels:
``fused_proto`` (K5) and ``kernel_probe`` (K6). Each is a module with a
``main()`` that runs the script's own shape on one card."""
