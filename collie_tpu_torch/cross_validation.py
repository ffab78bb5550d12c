"""Import-path parity module: ``collie_tpu_torch.cross_validation`` mirrors
``collie.cross_validation`` (reference ``collie/cross_validation.py``)."""
from collie_tpu_torch.data.cross_validation import random_split, stratified_split

__all__ = ['random_split', 'stratified_split']
