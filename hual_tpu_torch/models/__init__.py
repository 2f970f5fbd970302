from hual_tpu_torch.models.registry import get_model_class
from hual_tpu_torch.models.seqpan import SeqPAN

__all__ = ["SeqPAN", "get_model_class"]
