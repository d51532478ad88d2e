"""Work models of the port's kernels and of a model step, frozen with the
benchmark: the operations and bytes a call needs, and the least time the
card could take for them."""
