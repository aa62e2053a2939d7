"""Fleet utilities (reference: `paddle_tpu/distributed/fleet/utils/`)."""
