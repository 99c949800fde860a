"""The models behind the router: decoder-only LM building blocks and the
transformer the tier engines serve (the dense GQA family: yi-6b,
internlm2-20b), and the recsys rankers (DLRM, DCN-v2, DeepFM, DIEN)."""
