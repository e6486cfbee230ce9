"""Optimisers written as plain tensor code over dicts of parameters:
AdamW, SGD with momentum, the cosine schedule and global-norm clipping;
int8 gradient compression with error feedback."""
