"""The FlexVector SpMM kernels (CUDA, built at first use) and their oracles."""
