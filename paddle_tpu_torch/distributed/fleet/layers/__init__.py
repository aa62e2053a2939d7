"""Fleet's model-parallel layers (reference: `paddle_tpu/distributed/fleet/layers/`)."""
