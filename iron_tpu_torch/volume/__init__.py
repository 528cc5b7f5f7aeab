"""Stage-1 volume rendering (counterpart of iron_tpu/volume)."""
