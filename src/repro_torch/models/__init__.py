"""CNN front ends: the paper's Fig. 5 student (`cnn`)."""
