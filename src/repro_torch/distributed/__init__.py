"""Sharding rules, collectives and pipeline stages on torch.distributed
(the reference's repro.distributed)."""
