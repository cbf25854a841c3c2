"""One driver per path of the port, named by a traffic mix's ``kind``:
``train`` (``Trainer.train_step`` fed by the trainer's pipeline) and
``offline`` (``eval.evaluator.evaluate`` over a test set)."""
