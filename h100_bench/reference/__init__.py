"""The plain reference: float32 PyTorch and NumPy only.  It imports
neither JAX nor the port, and takes nothing the program made."""
