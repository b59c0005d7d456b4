from . import bert, gpt, lenet, resnet

__all__ = ["bert", "gpt", "lenet", "resnet"]
