"""Device compute building blocks: matmul FFTs and scatter/deposit ops."""
