"""Manifest checkpoints in the reference's on-disk format, single process
or one shard pair a rank of a mesh, with the elastic restore
(``checkpoint.py``), and the background writer (``writer.py``)."""
from repro_torch.checkpoint.checkpoint import (MANIFEST,  # noqa: F401
                                               Snapshot, is_complete,
                                               latest_step_path, load_flat,
                                               read_metadata, restore,
                                               restore_structured, save,
                                               saved_shardings, snapshot,
                                               write_snapshot)
from repro_torch.checkpoint.writer import (AsyncCheckpointWriter,  # noqa: F401
                                           CheckpointWriteError)
