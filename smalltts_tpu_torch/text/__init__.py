from smalltts_tpu_torch.text.vocab import (
    NV_REPEAT,
    decode_token_ids,
    get_sed_event_id,
    idx2p,
    p2idx,
    phoneme_len,
    phonemes,
)
from smalltts_tpu_torch.text.phonemize import get_token_ids, merge_transcript

__all__ = [
    "NV_REPEAT",
    "decode_token_ids",
    "get_sed_event_id",
    "get_token_ids",
    "idx2p",
    "merge_transcript",
    "p2idx",
    "phoneme_len",
    "phonemes",
]
