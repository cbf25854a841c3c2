"""Framework-wide constants.

Word id reservations mirror the reference contract
(`Utils/Constants.py:4-10`, `Utils/CoQAPreprocess.py:514-518`): vocabulary
rows 0..4 are ``<PAD> <UNK> <Q> <OCR> <OD>``. Downstream code relies on
PAD==0 (mask = id != 0).
"""

PAD_WORD_ID = 0
UNK_WORD_ID = 1
Q_WORD_ID = 2
OCR_WORD_ID = 3
OD_WORD_ID = 4

RESERVED_WORDS = ["<PAD>", "<UNK>", "<Q>", "<OCR>", "<OD>"]
RESERVED_CHARS = ["<PAD>", "<UNK>", "<STA>", "<END>"]

# Sentinel answer strings (`Models/SDNetTrainer.py:418-426`).
ANSWER_NOREAD = "answering does not require reading text in the image"
ANSWER_YES = "yes"
ANSWER_NO = "no"
ANSWER_UNANSWERABLE = "unanswerable"

# OCR/OD end-of-list sentinel tokens appended per candidate list
# (`Utils/VQA_Dataset.py:336-349`).
OCR_SENTINEL = "<OCR>"
OD_SENTINEL = "<OD>"
