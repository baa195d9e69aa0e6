"""Multi-device and multi-process search: the shard mesh and its
collectives (`mesh`), the sharded walker (`mesh`) and the sharded BSGS
table (`bsgs_sharded`). Counterpart of keyhunt_tpu/parallel, on
`torch.distributed` in place of `jax.sharding` and `shard_map`."""
