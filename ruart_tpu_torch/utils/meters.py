"""Running-average meter (reference `Utils/CoQAUtils.py:837-858`). Copy of
``ruart_tpu/utils/meters.py``."""


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0

    def state_dict(self):
        return {"val": self.val, "avg": self.avg, "sum": self.sum, "count": self.count}

    def load_state_dict(self, state):
        self.val = state["val"]
        self.avg = state["avg"]
        self.sum = state["sum"]
        self.count = state["count"]
