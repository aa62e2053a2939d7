"""Layer: the module base class — port of `paddle_tpu/nn/layer/layers.py`.

Parameter, sublayer and buffer registries, forward hooks, `state_dict`
with paddle's structured names, train/eval mode and `.to()` movement,
as in the reference. Parameters are the port's `Parameter`s, whose
`_data` are torch leaves. `set_state_dict` takes Tensors, torch tensors
or numpy arrays, so a model can start from the reference's weights
(`state_dict()` of the reference's Layer, as numpy arrays). The
reference's jit bridge (`functional_state`) is left for a later slice.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from ...core import dtype as dtype_mod
from ...core.place import to_place
from ...core.tensor import Parameter, Tensor


class HookRemoveHelper:
    def __init__(self, hooks, key):
        self._hooks = hooks
        self._key = key

    def remove(self):
        self._hooks.pop(self._key, None)


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self.training = True
        self._dtype = dtype
        self._parameters: Dict[str, Optional[Parameter]] = collections.OrderedDict()
        self._sub_layers: Dict[str, "Layer"] = collections.OrderedDict()
        self._buffers: Dict[str, Optional[Tensor]] = collections.OrderedDict()
        self._non_persistable_buffer_names = set()
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()
        self._hook_id = 0
        self._name_scope = name_scope or self.__class__.__name__.lower()

    # -- attribute routing ---------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call Layer.__init__ before assigning parameters")
            params[name] = value
            layers is not None and layers.pop(name, None)
            buffers is not None and buffers.pop(name, None)
            self.__dict__.pop(name, None)
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError("call Layer.__init__ before assigning sublayers")
            layers[name] = value
            params is not None and params.pop(name, None)
            self.__dict__.pop(name, None)
        elif params is not None and name in params:
            if value is None:
                params[name] = None
            elif isinstance(value, Tensor):
                params[name] = Parameter.from_tensor(value)
            else:
                raise TypeError(f"cannot assign {type(value)} to parameter {name!r}")
        elif buffers is not None and name in buffers:
            buffers[name] = value
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(f"'{type(self).__name__}' object has no attribute '{name}'")

    def __delattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    def __dir__(self):
        return list(super().__dir__()) + list(self._parameters) + list(self._sub_layers) + list(self._buffers)

    # -- registration --------------------------------------------------------
    def add_parameter(self, name: str, parameter: Optional[Parameter]):
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name: str, sublayer: "Layer"):
        self._sub_layers[name] = sublayer
        return sublayer

    def register_buffer(self, name: str, tensor: Optional[Tensor], persistable: bool = True):
        if tensor is not None and not isinstance(tensor, Tensor):
            tensor = Tensor(tensor)
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        return tensor

    def create_parameter(
        self,
        shape,
        attr=None,
        dtype=None,
        is_bias=False,
        default_initializer=None,
    ) -> Parameter:
        from .. import initializer as I

        dtype = dtype or self._dtype or dtype_mod.get_default_dtype()
        init = default_initializer
        name = None
        learning_rate = 1.0
        trainable = True
        if attr is not None and attr is not False:
            from ..param_attr import ParamAttr

            if isinstance(attr, ParamAttr):
                init = attr.initializer or init
                name = attr.name
                learning_rate = attr.learning_rate
                trainable = attr.trainable
            elif isinstance(attr, I.Initializer):
                init = attr
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        data = init(shape, dtype)
        p = Parameter(data, name=name, trainable=trainable)
        p.optimize_attr["learning_rate"] = learning_rate
        return p

    def create_tensor(self, name=None, dtype=None):
        return Tensor(torch.zeros([0], dtype=dtype_mod.to_torch(
            dtype or self._dtype)))

    # -- iteration -----------------------------------------------------------
    def named_members(self, get_fn, prefix="", include_sublayers=True, seen=None):
        seen = seen if seen is not None else set()
        for name, member in get_fn(self):
            if member is None or id(member) in seen:
                continue
            seen.add(id(member))
            yield (f"{prefix}.{name}" if prefix else name), member
        if include_sublayers:
            for lname, layer in self._sub_layers.items():
                if layer is None:
                    continue
                sub_prefix = f"{prefix}.{lname}" if prefix else lname
                yield from layer.named_members(get_fn, sub_prefix, True, seen)

    def parameters(self, include_sublayers=True) -> List[Parameter]:
        return [p for _, p in self.named_parameters(include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True) -> Iterator[Tuple[str, Parameter]]:
        yield from self.named_members(
            lambda l: l._parameters.items(), prefix, include_sublayers
        )

    def buffers(self, include_sublayers=True) -> List[Tensor]:
        return [b for _, b in self.named_buffers(include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        yield from self.named_members(lambda l: l._buffers.items(), prefix, include_sublayers)

    def children(self) -> Iterator["Layer"]:
        for _, l in self.named_children():
            yield l

    def named_children(self):
        for name, l in self._sub_layers.items():
            if l is not None:
                yield name, l

    def sublayers(self, include_self=False) -> List["Layer"]:
        out = []
        for _, l in self.named_sublayers(include_self=include_self):
            out.append(l)
        return out

    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        layers_set = layers_set if layers_set is not None else set()
        if include_self and id(self) not in layers_set:
            layers_set.add(id(self))
            yield prefix, self
        for name, l in self._sub_layers.items():
            if l is None or id(l) in layers_set:
                continue
            layers_set.add(id(l))
            sub_prefix = f"{prefix}.{name}" if prefix else name
            yield sub_prefix, l
            yield from l.named_sublayers(sub_prefix, False, layers_set)

    def apply(self, fn: Callable):
        for l in self.children():
            l.apply(fn)
        fn(self)
        return self

    # -- mode ----------------------------------------------------------------
    def train(self):
        self.training = True
        for l in self.sublayers():
            l.training = True
        return self

    def eval(self):
        self.training = False
        for l in self.sublayers():
            l.training = False
        return self

    # -- state dict ----------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True, use_hook=True):
        dest = destination if destination is not None else collections.OrderedDict()
        for name, p in self.named_parameters(include_sublayers=include_sublayers):
            dest[name] = p
        for name, b in self.named_buffers(include_sublayers=include_sublayers):
            short = name.rsplit(".", 1)[-1]
            owner = self._locate(name)
            if owner is not None and short in owner._non_persistable_buffer_names:
                continue
            dest[name] = b
        return dest

    def _locate(self, qualified_name):
        parts = qualified_name.split(".")[:-1]
        layer = self
        for p in parts:
            layer = layer._sub_layers.get(p)
            if layer is None:
                return None
        return layer

    def set_state_dict(self, state_dict, use_structured_name=True):
        own = self.state_dict()
        missing, unexpected = [], []
        for name, target in own.items():
            if name in state_dict:
                target.set_value(state_dict[name])
            else:
                missing.append(name)
        for name in state_dict:
            if name not in own:
                unexpected.append(name)
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- device/dtype movement -----------------------------------------------
    def to(self, device=None, dtype=None, blocking=None):
        dev = None if device is None else to_place(device).torch_device()
        td = None if dtype is None else dtype_mod.to_torch(dtype)

        def _convert(t: Tensor):
            if t is None or (dev is None and td is None):
                return
            d = t._data
            # a new leaf in place of the old, keeping requires_grad
            t._data = d.detach().to(device=dev, dtype=td).requires_grad_(
                d.requires_grad and (td is None or td.is_floating_point))

        for _, p in self.named_parameters():
            _convert(p)
        for _, b in self.named_buffers():
            _convert(b)
        if dtype is not None:
            self._dtype = str(dtype_mod.DType(dtype))
            for l in self.sublayers(include_self=True):
                l._dtype = self._dtype
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    def half(self):
        return self.to(dtype="float16")

    # -- hooks ---------------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        self._hook_id += 1
        self._forward_pre_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_pre_hooks, self._hook_id)

    def register_forward_post_hook(self, hook):
        self._hook_id += 1
        self._forward_post_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_post_hooks, self._hook_id)

    # -- call ----------------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            result = hook(self, inputs)
            if result is not None:
                inputs = result if isinstance(result, tuple) else (result,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            result = hook(self, inputs, outputs)
            if result is not None:
                outputs = result
        return outputs

    # -- functional bridge ---------------------------------------------------
    def functional_state(self):
        """({name: parameter tensor}, {name: buffer tensor or None}): the
        layer's torch tensors by structured name, as they are (no copy),
        for a function of the state such as `torch.func.functional_call`
        (the reference returns jax arrays for its jitted steps)."""
        params = {n: p._data for n, p in self.named_parameters()}
        bufs = {n: (b._data if b is not None else None)
                for n, b in self.named_buffers()}
        return params, bufs

    def load_functional_state(self, params=None, buffers=None):
        """Install torch tensors back into the layer by name (after a
        functional step); names the layer does not have are ignored."""
        if params:
            own = dict(self.named_parameters())
            for n, arr in params.items():
                if n in own:
                    own[n]._data = arr
        if buffers:
            ownb = dict(self.named_buffers())
            for n, arr in buffers.items():
                if n in ownb and arr is not None and ownb[n] is not None:
                    ownb[n]._data = arr
        return self

    def full_name(self):
        return self._name_scope

    def extra_repr(self):
        return ""

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, l in self._sub_layers.items():
            sub = repr(l).split("\n")
            sub = [sub[0]] + ["  " + s for s in sub[1:]]
            lines.append(f"  ({name}): " + "\n".join(sub))
        main = f"{type(self).__name__}({extra}"
        if lines:
            return main + "\n" + "\n".join(lines) + "\n)"
        return main + ")"

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()
