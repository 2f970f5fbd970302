from hual_tpu_torch.active.coefficients import F_RENEW, RoundCoeffs, get_coff
from hual_tpu_torch.active.engine import update_labels

__all__ = ["F_RENEW", "RoundCoeffs", "get_coff", "update_labels"]
