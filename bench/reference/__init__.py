"""The plain PyTorch reference of one madeye-approx fleet step: a frozen
copy of the port's plain paths, importing nothing of the port."""
