"""Decoder-only LM building blocks and the transformer the tier engines
serve (the dense GQA family: yi-6b, internlm2-20b)."""
