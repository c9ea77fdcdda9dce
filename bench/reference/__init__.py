"""Plain float32 PyTorch references, one module per model family.

Each module gives ``layout(c)``: the parameter tree it reads, as (key path,
shape, dtype name, mean, std) rows in the program's key names, with the
benchmark's own draw for each leaf; and ``row_loss(c, params, tokens,
labels, mm)``: the summed next-token cross-entropy of one sequence.  ``c``
is the configuration file's dict, ``params`` the tree with each stacked
``units`` leaf a list of one tensor per layer, ``mm`` the matrix product
(:data:`bench.reference.common.MATMULS`).  They import nothing of the
program."""
