"""Backbones of the port: the CIFAR ResNets, BN folding and the converter."""

from .convert import state_dict_from_flax
from .fold import fold_batchnorm
from .resnet import BasicBlock, ResNet, ResNet10, ResNet18
