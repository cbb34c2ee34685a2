'''Mask+Keypoint R-CNN (R50-FPN) in PyTorch: the port of the JAX package's
``models/`` (config, weights, backbone, FPN, RPN, ROI heads, predictor).

Exports the names of the JAX package's ``models/__init__.py`` (``__all__``).
'''
from .config import ModelConfig, get_base_config
from .rcnn import MaskKeypointRCNN

__all__ = ['ModelConfig', 'get_base_config', 'MaskKeypointRCNN']
