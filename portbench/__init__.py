"""The benchmark of ``topk_rec_torch`` on the H100 (see README.md)."""
