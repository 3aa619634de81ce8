"""Plain PyTorch references that decide `correct`. They import neither
JAX nor either package of the system: only torch and each other."""
