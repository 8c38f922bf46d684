"""``repro_torch.storage`` — durability for the port's graph stores.

Port of ``repro.storage``, with one on-disk format: a directory written
by either package (WAL segments, full and incremental checkpoints) is
recovered by the other into the same state. Epoch-consistent
checkpoints (full + incremental block-row deltas, per-array CRCs) are
the snapshots, an fsync-batched write-ahead log of applied ``OpBatch``es
is the log, and recovery is "load the newest valid chain, replay the WAL
suffix through the deterministic ``GraphStore.apply``" on the store's
device.

    from repro_torch.storage import DurableStore, recover

    store = DurableStore(make_store("local", ...), "/data/graph",
                         group_commit=32, checkpoint_every=256)
    store.apply(OpBatch.edges(src, dst, w))     # logged before applied
    store.checkpoint()                          # seal + rotate + GC

    store, report = recover("/data/graph", lambda: make_store("local", ...))

``faultfs`` holds the fault-injection harness the recovery tests drive
(torn WAL tails, flipped bytes, torn checkpoint directories);
``python -m repro_torch.storage.crash_smoke`` kills a real ingest process
and checks what recovery gives back.
"""
from .checkpoint import (CheckpointError, checkpoint_ids,
                         latest_recoverable, resolve_checkpoint,
                         restore_graph_checkpoint, save_graph_checkpoint)
from .durable import DurabilityConfig, DurableStore, recover
from .faultfs import FaultInjector, InjectedCrash
from .wal import (WalRecord, WalScan, WalWriter, decode_batch,
                  encode_batch, encode_record, read_wal, read_wal_dir,
                  wal_segments)

__all__ = [
    "CheckpointError", "checkpoint_ids", "latest_recoverable",
    "resolve_checkpoint", "restore_graph_checkpoint",
    "save_graph_checkpoint",
    "DurabilityConfig", "DurableStore", "recover",
    "FaultInjector", "InjectedCrash",
    "WalRecord", "WalScan", "WalWriter", "decode_batch", "encode_batch",
    "encode_record", "read_wal", "read_wal_dir", "wal_segments",
]
