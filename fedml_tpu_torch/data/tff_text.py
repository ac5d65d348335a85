"""The TFF Shakespeare character vocabulary.

Port of the vocabulary half of ``fedml_tpu/data/tff_text.py``
(``SHAKESPEARE_CHAR_VOCAB``, ``shakespeare_word_dict``,
``shakespeare_vocab_size``), copied verbatim so both packages size the
language model's head alike: ``[<pad>] + CHAR_VOCAB + [<bos>] + [<eos>]``
plus one out-of-vocabulary bucket, 90 ids.  The h5 preprocessing of the
natural partitions is not ported yet (port item A2).
"""

from __future__ import annotations

from typing import Dict

#: the TFF shakespeare char vocabulary, verbatim
#: (`fed_shakespeare/utils.py:18-20`)
SHAKESPEARE_CHAR_VOCAB = list(
    "dhlptx@DHLPTX $(,048cgkoswCGKOSW[_#'/37;?bfjnrvzBFJNRVZ\"&*.26:"
    "\naeimquyAEIMQUY]!%)-159\r"
)
SHAKESPEARE_SEQ_LEN = 80          # McMahan et al. AISTATS 2017
PAD, BOS, EOS = "<pad>", "<bos>", "<eos>"


def shakespeare_word_dict() -> Dict[str, int]:
    words = [PAD] + SHAKESPEARE_CHAR_VOCAB + [BOS] + [EOS]
    return {w: i for i, w in enumerate(words)}


def shakespeare_vocab_size() -> int:
    return len(shakespeare_word_dict()) + 1          # +1 OOV bucket
