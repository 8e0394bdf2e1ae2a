"""Device operations: top-k selection and the hand-written CUDA kernels
(``maxsim`` — K1, ``sparse_scan`` — K3/K3b), each beside its plain version."""
