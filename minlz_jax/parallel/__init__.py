"""Multi-device / multi-host scaling of block batches."""

from .mesh import (
    assemble_blocks,
    make_mesh,
    sharded_decode_parse,
    sharded_encode_blocks,
    sharded_encode_blocks_dict,
    sharded_pipeline_step,
)

__all__ = [
    "assemble_blocks",
    "make_mesh",
    "sharded_decode_parse",
    "sharded_encode_blocks",
    "sharded_encode_blocks_dict",
    "sharded_pipeline_step",
]
