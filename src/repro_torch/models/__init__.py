"""The MadEye approximation detector (ViT backbone + FPN-lite neck +
anchor-free heads) as functions on parameter dictionaries."""
