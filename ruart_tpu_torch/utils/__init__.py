from ruart_tpu_torch.utils.meters import AverageMeter
from ruart_tpu_torch.utils.timing import Timers
