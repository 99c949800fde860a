"""Model configurations: the LLM tiers behind the router (yi-6b,
internlm2-20b) and the recsys rankers (deepfm, dcn-v2)."""
