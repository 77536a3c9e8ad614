"""Plain PyTorch references of what the benchmark's cells compute.

Nothing here imports ``topk_rec_torch``: the references take the
benchmark's own inputs and judge the program's outputs."""
