"""ParamAttr (reference: python/paddle/base/param_attr.py).

A copy of `paddle_tpu/nn/param_attr.py` (jax-free).
"""
from __future__ import annotations


class ParamAttr:
    def __init__(
        self,
        name=None,
        initializer=None,
        learning_rate=1.0,
        regularizer=None,
        trainable=True,
        do_model_average=True,
        need_clip=True,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg):
        if arg is None or isinstance(arg, ParamAttr) or arg is False:
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        return ParamAttr(initializer=arg)
