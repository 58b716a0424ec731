"""Durability layer: crash-safe writes (copy of trivy_tpu.durability's
`atomic` module; the journal and append log are not ported yet)."""
