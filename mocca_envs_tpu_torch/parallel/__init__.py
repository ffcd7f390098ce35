"""Multi-device runs over ``torch.distributed``: the ``env`` mesh (one
process per device), sharded env stepping, and multi-process bring-up.
Counterpart of ``mocca_envs_tpu/parallel/``."""
