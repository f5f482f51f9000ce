"""Checkpoints and versioned table artifacts, in the reference's on-disk
format (:mod:`repro_torch.checkpoint.io`)."""

from repro_torch.checkpoint.io import (
    MANIFEST_NAME,
    ServableTable,
    latest_step_path,
    load_checkpoint,
    load_manifest,
    load_table,
    next_version,
    publish_table,
    save_checkpoint,
)

__all__ = [
    "MANIFEST_NAME",
    "ServableTable",
    "latest_step_path",
    "load_checkpoint",
    "load_manifest",
    "load_table",
    "next_version",
    "publish_table",
    "save_checkpoint",
]
