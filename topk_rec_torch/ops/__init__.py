"""Device ops of the port: the fused score + seen-mask + top-k kernel (K1)."""
