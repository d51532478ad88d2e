"""Plain references the benchmark judges the program's outputs by.  They
import nothing of the program, of JAX or of the JAX package."""
