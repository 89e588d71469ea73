"""The plain reference: smalltts's backbone, sampler, codec decode and
teacher step in plain PyTorch ops, written for this benchmark alone. It
imports nothing of the program under test and nothing of JAX."""
