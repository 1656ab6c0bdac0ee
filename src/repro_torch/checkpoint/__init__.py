"""Single-process manifest checkpoints in the reference's on-disk format
(``checkpoint.py``) and the background writer (``writer.py``)."""
from repro_torch.checkpoint.checkpoint import (MANIFEST,  # noqa: F401
                                               Snapshot, is_complete,
                                               latest_step_path, load_flat,
                                               read_metadata, restore,
                                               restore_structured, save,
                                               snapshot, write_snapshot)
from repro_torch.checkpoint.writer import (AsyncCheckpointWriter,  # noqa: F401
                                           CheckpointWriteError)
