"""Device-resident procedural scenes, their oracle pass and the crop
image model, driven by threefry keys (`prng`)."""
