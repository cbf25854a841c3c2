"""Framework-wide constants.

Word/char id reservations mirror the reference contract
(`Utils/Constants.py:4-10`, `Utils/CoQAPreprocess.py:514-518,545-549`):
vocabulary rows 0..4 are ``<PAD> <UNK> <Q> <OCR> <OD>`` and char rows 0..3 are
``<PAD> <UNK> <STA> <END>``. Downstream code relies on PAD==0 (mask = id != 0).
"""

PAD_WORD_ID = 0
UNK_WORD_ID = 1
Q_WORD_ID = 2
OCR_WORD_ID = 3
OD_WORD_ID = 4

RESERVED_WORDS = ["<PAD>", "<UNK>", "<Q>", "<OCR>", "<OD>"]
RESERVED_CHARS = ["<PAD>", "<UNK>", "<STA>", "<END>"]

PAD_CHAR_ID = 0
UNK_CHAR_ID = 1
STA_CHAR_ID = 2
END_CHAR_ID = 3

# Sentinel answer strings (`Models/SDNetTrainer.py:418-426`).
ANSWER_NOREAD = "answering does not require reading text in the image"
ANSWER_YES = "yes"
ANSWER_NO = "no"
ANSWER_UNANSWERABLE = "unanswerable"

# OCR/OD end-of-list sentinel tokens appended per candidate list
# (`Utils/VQA_Dataset.py:336-349`).
OCR_SENTINEL = "<OCR>"
OD_SENTINEL = "<OD>"

# PHOC feature layout (`Utils/cphoc.c:24-29,73`): 36 unigrams over pyramid
# levels 2..5 (14 regions -> 504 dims) + 50 bigrams over 2 regions (100 dims).
PHOC_DIM = 604
PHOC_UNIGRAMS = "abcdefghijklmnopqrstuvwxyz0123456789"
PHOC_BIGRAMS = [
    "th", "he", "in", "er", "an", "re", "es", "on", "st", "nt",
    "en", "at", "ed", "nd", "to", "or", "ea", "ti", "ar", "te",
    "ng", "al", "it", "as", "is", "ha", "et", "se", "ou", "of",
    "le", "sa", "ve", "ro", "ra", "ri", "hi", "ne", "me", "de",
    "co", "ta", "ec", "si", "ll", "so", "na", "li", "la", "el",
]
PHOC_LEVELS = (2, 3, 4, 5)
PHOC_ALPHABET = set(PHOC_UNIGRAMS)
