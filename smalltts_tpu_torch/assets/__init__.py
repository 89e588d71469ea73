"""Asset management: idempotent fetch of model weights from a model hub
(port of smalltts_tpu/assets)."""
