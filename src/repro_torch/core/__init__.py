"""Circuit model, evaluation and the (1+λ) evolution / sweep engine."""
