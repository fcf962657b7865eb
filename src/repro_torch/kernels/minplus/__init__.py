"""Min-plus ELL relaxation: kernels, wrappers, plain version and fixpoint loop."""
