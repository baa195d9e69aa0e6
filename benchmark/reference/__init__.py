"""The benchmark's plain reference: secp256k1, hash160, and the checks
that decide `correct`. Imports nothing of keyhunt_tpu_torch, nothing of
keyhunt_tpu and no jax."""
