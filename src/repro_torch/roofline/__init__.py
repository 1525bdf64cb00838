"""Three-term roofline of a traced step on H100 constants."""
