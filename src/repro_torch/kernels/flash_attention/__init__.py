"""Flash attention forward kernel (B9), GQA-aware."""
