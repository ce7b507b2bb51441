"""Plain float32 references of the model families the cells run, one
module a family (``configs/<config>.json`` names it), each with the
family's model FLOPs a call (``model_flops``).  They import nothing
of the program: the benchmark draws the weights and hands the same
tensors to the program and to its reference."""
