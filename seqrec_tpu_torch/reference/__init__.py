"""Plain PyTorch references of models the port runs and the JAX package
lacks; they import nothing of the port."""
