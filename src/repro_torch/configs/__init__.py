"""Model configurations of the LLM tiers behind the router."""
