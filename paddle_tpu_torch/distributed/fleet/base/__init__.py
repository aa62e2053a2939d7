"""Fleet's strategy and topology (reference: `paddle_tpu/distributed/fleet/base/`)."""
