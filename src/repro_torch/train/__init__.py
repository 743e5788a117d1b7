"""Training pieces the in-episode learner needs: the hand-written
AdamW/SGD updates and the cosine schedule (`optim.py`)."""
