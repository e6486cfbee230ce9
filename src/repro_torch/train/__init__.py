"""The paper-scale CNN trainer (§II): CE, KD with curriculum, iterative
pruning and QAT."""
