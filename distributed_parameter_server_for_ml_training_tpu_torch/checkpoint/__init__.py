"""Checkpoint/resume of the port (the JAX package's ``checkpoint/``).

The reference holds parameters only in server RAM (server.py:96) and lists
"checkpointing to S3" as future work (DEPLOYMENT.md:309). Here both canonical
state holders checkpoint natively:

- train states (params + optimizer state + BN stats + step) via
  ``torch.save``,
- the parameter stores via the JAX package's npz + JSON snapshot,
  format-identical.
"""

from .manager import (
    CheckpointManager,
    PeriodicStoreCheckpointer,
    STORE_SNAPSHOT_VERSION,
    check_job_identity,
    check_shard_identity,
    load_store_record,
    restore_server_state,
    restore_store,
    save_store,
)

__all__ = ["CheckpointManager", "PeriodicStoreCheckpointer",
           "STORE_SNAPSHOT_VERSION", "check_job_identity",
           "check_shard_identity", "load_store_record",
           "restore_server_state", "restore_store", "save_store"]
