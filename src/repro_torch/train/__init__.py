"""Training: the staged AgileNN pipeline and the generic loop."""
