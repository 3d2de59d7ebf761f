"""The paper's own evaluation networks (Table VIII): LeNet / LeNet+ /
AlexNet / VGG16 / ResNet-19 over MNIST- and CIFAR10-shaped inputs (the JAX
package's ``configs/paper_cnns.py``, copied).

These are not LM ``ModelConfig``s; ``paper/table_viii.py`` and
``examples/lenet_mnist_qat.py`` build them through ``models/cnn.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["CNNSpec", "CNN_SPECS"]


@dataclasses.dataclass(frozen=True)
class CNNSpec:
    name: str
    dataset: str                 # mnist | cifar10
    in_shape: Tuple[int, int, int]
    num_classes: int = 10


CNN_SPECS = {
    "lenet-mnist": CNNSpec("lenet", "mnist", (28, 28, 1)),
    "lenet_plus-mnist": CNNSpec("lenet_plus", "mnist", (28, 28, 1)),
    "lenet-cifar10": CNNSpec("lenet", "cifar10", (32, 32, 3)),
    "lenet_plus-cifar10": CNNSpec("lenet_plus", "cifar10", (32, 32, 3)),
    "alexnet-cifar10": CNNSpec("alexnet", "cifar10", (32, 32, 3)),
    "vgg16-cifar10": CNNSpec("vgg16", "cifar10", (32, 32, 3)),
    "resnet19-cifar10": CNNSpec("resnet19", "cifar10", (32, 32, 3)),
}
