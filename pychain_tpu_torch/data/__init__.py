"""The data layer (the port of ``pychain_tpu/data``): length bucketing,
Kaldi feature ark/scp I/O, chunked supervision, background prefetching
with host->device copies, and wav -> filterbank features (numpy for one
utterance, PyTorch on a device for a batch).  The same 26 names as the
JAX package's ``pychain_tpu.data``."""

from .bucketing import BucketSpec, LengthBucketer, pad_to_bucket
from .chunking import ChunkPlan, chunk_alignment, chunk_supervision
from .features import (FbankConfig, add_deltas, add_deltas_batch,
                       cmvn, cmvn_batch, fbank, fbank_batch, mel_banks,
                       mfcc, num_frames, read_wav, write_wav)
from .prefetch import Prefetcher, prefetch
from .kaldi_features import (
    load_scp_entry,
    scan_feats_ark,
    read_feats_ark,
    read_scp,
    write_feats_ark,
    write_scp,
)

__all__ = [
    "BucketSpec",
    "ChunkPlan",
    "chunk_alignment",
    "chunk_supervision",
    "LengthBucketer",
    "pad_to_bucket",
    "read_feats_ark",
    "write_feats_ark",
    "read_scp",
    "write_scp",
    "load_scp_entry",
    "scan_feats_ark",
    "Prefetcher",
    "prefetch",
    "FbankConfig",
    "add_deltas",
    "add_deltas_batch",
    "cmvn",
    "cmvn_batch",
    "mfcc",
    "fbank",
    "fbank_batch",
    "mel_banks",
    "num_frames",
    "read_wav",
    "write_wav",
]
