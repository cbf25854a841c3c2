"""A frozen, plain copy of the port's model and data path: the benchmark's
reference.

Copied from ``ruart_tpu_torch`` as it stood when the benchmark was
written, with its imports pointed here, and kept as it is from then on, so
that a change to the port is always measured against the same arithmetic.
It imports nothing of the port. What differs from the port:

* attention is the plain softmax version (``plain.attention_rows_plain``)
  under autograd: no CUDA kernel, no CUDA graph;
* the collator collates with numpy (no native fill loops);
* one process: the mesh helpers are their one-rank identities, and the
  int8 encoder, PHOC tables and image-feature packs are not here;
* callers set ``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32`` to False (``portbench.check``).

Files: ``config``, ``constants``, ``featurizer``, ``wordpiece``,
``preprocess``, ``dataset``, ``collate``, ``metrics``, ``decoder`` (the
host path: featurize, item build, collate, decode), ``bert_config``,
``bert``, ``spec``, ``layers``, ``rnn``, ``deep_attention``, ``model``
(the network), ``loss``, ``optim`` (the train step's loss and Adamax).
"""
