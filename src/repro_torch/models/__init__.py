"""The port's models as functions on parameter dictionaries: the MadEye
approximation detector (ViT backbone + FPN-lite neck + anchor-free
heads) and the model zoo (LMs, ViTs, Swin, DiT, the MMDiT and their
samplers)."""
