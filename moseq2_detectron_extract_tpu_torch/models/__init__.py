'''Mask+Keypoint R-CNN (R50-FPN) in PyTorch: the port of the JAX package's
``models/`` (config, weights, backbone, FPN, RPN, ROI heads, predictor).'''
