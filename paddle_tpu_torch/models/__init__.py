from . import bert, gpt, lenet, resnet, transformer

__all__ = ["bert", "gpt", "lenet", "resnet", "transformer"]
