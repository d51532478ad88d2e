"""PyTorch/CUDA port of the CGP approximate-circuit search (``repro``).

Mirrors ``repro``'s module names.  Imports torch and numpy only; the JAX
package is the reference it is tested against, never a dependency.
"""
