"""Optimization methods (≙ ``bigdl_tpu/optim/optim_method.py``): the
:class:`OptimMethod` contract, :class:`SGD`, :class:`Adam`, :class:`AdamW`,
:class:`Adagrad`, :class:`Adadelta`, :class:`Adamax`, :class:`RMSprop`,
:class:`Ftrl`, :class:`LBFGS`, :class:`LARS` and :class:`LAMB`.

The reference's contract, on nested dicts of tensors::

    state = method.init_state(params)
    params, state = method.update(grads, params, state)

with two differences that PyTorch allows and the training step wants:

  * ``update`` writes the new parameters and moments into the tensors it
    was given and returns them: the counterpart of the reference trainer
    donating its parameter and optimizer buffers (``donate_argnums``).
  * ``state["step"]`` is a device ``int32`` tensor, and the step's
    learning rate ``clr = rate(step) / (1 + step * lr_decay)`` (and Adam's
    bias corrections ``bc1 = 1 - beta1^t`` and ``bc2``) are fp32 device
    scalars, computed in the reference's order.  An update makes no host
    sync.

``fused=True`` sends every f32 leaf on a CUDA tensor to the hand-written
kernel (``kernels.fused_optim``: K4 for Adam, K5 for SGD with momentum,
K6 for SGD without) and every CPU leaf to its plain version; a CUDA leaf
that is not f32 raises.  ``fused=False`` is the reference's tree-map math
in plain PyTorch ops, which is the same plain version, on any device.

The methods after ``AdamW`` are the reference's tree-map math in plain
PyTorch ops on the device (the reference has no Pallas kernel for them),
in its op order, writing in place as above.  The stateful reference
interface ``optimize(feval, x)`` runs on top of ``update`` (LBFGS has its
own, host-driven as the reference's is: it reads the loss on the host).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from ..kernels.fused_optim import (fused_adam_update,
                                   fused_adam_update_plain, fused_sgd_update,
                                   fused_sgd_update_plain, zip_leaves)
from .lr_schedule import Default, _fill


def _tmap(f, tree):
    if isinstance(tree, dict):
        return {k: _tmap(f, v) for k, v in tree.items()}
    return f(tree)


def _device_of(params) -> torch.device:
    for (leaf,) in zip_leaves(params):
        return leaf.device
    raise ValueError("init_state: params has no leaves")


def _unflatten(like, leaves):
    """A tree of ``like``'s structure over ``leaves`` (in ``zip_leaves``
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return next(it)
    return build(like)


def _write(dst, value):
    """``value`` into ``dst`` in place (the update's buffers are the
    caller's); returns ``dst``."""
    with torch.no_grad():
        return dst.copy_(value)


class OptimMethod:
    """Base class. Subclasses define init_state / update."""

    nevals = 0           # optimize() calls (the reference's counter)
    _ref_state = None    # optimize()'s state

    def init_state(self, params) -> Dict[str, Any]:
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_device_of(params))}

    def update(self, grads, params, state):
        raise NotImplementedError

    def get_learning_rate(self, state):
        return 0.0

    def save(self, path, overwrite=True):
        """Persist this method (hyperparameters and schedule) in the
        no-pickle state format (≙ OptimMethod.save)."""
        import os
        if os.path.exists(path) and not overwrite:
            raise FileExistsError(path)
        from ..utils.serializer import save_state_file
        save_state_file({"optim_method": self}, path)
        return self

    @staticmethod
    def load(path):
        """Inverse of :meth:`save` (≙ OptimMethod.load)."""
        from ..utils.serializer import load_state_file
        obj = load_state_file(path).get("optim_method")
        if not isinstance(obj, OptimMethod):
            raise ValueError(f"{path}: not an OptimMethod file")
        return obj

    # -- the reference's stateful interface ----------------------------- #
    def optimize(self, feval: Callable, x):
        """One step of ``feval(x) -> (loss, grad)`` at ``x`` (a tensor or a
        dict of them): ``(new_x, [loss])``, the state kept on the method
        (≙ OptimMethod.optimize)."""
        if self._ref_state is None:
            self._ref_state = self.init_state(x)
        else:
            # a state restored by load() holds host arrays
            dev = _device_of(x)
            self._ref_state = _tmap(
                lambda v: v if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v)).to(dev),
                self._ref_state)
        loss, grad = feval(x)
        new_x, self._ref_state = self.update(grad, x, self._ref_state)
        self.nevals += 1
        return new_x, [loss]

    def clear_history(self):
        self._ref_state = None
        return self

    def state_dict(self):
        return self._ref_state


def _current_lr(method, state):
    """``rate(step) / (1 + step * lr_decay)``: an fp32 device scalar."""
    step = state["step"]
    # a device tensor as the schedule computed it, or a host float filled
    # on the device (not copied from the host): no host sync
    rate = _fill(method.schedule.rate(method, step), step)
    return rate / (1.0 + step * method.lr_decay)


class SGD(OptimMethod):
    """optim/SGD.scala: learning-rate schedule and per-step decay, weight
    decay, momentum with dampening (which defaults to ``momentum``, not to
    0 as in ``torch.optim.SGD``) and Nesterov.  The velocity starts at 0
    and exists only when ``momentum > 0``.

    ``learning_rates`` and ``weight_decays`` (the reference's per-parameter
    tensors) are accepted as the reference accepts them: it stores
    neither and does not use them, and so the port does the same."""

    def __init__(self, learning_rate=1e-3, learning_rate_decay=0.0,
                 weight_decay=0.0, momentum=0.0, dampening=None,
                 nesterov=False, learning_rate_schedule=None,
                 learning_rates=None, weight_decays=None, fused=False):
        self.lr = learning_rate
        self.lr_decay = learning_rate_decay
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        self.schedule = learning_rate_schedule or Default()
        self.fused = bool(fused)
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError(
                "Nesterov momentum requires momentum > 0 and dampening = 0")

    def init_state(self, params):
        st = super().init_state(params)
        if self.momentum > 0:
            st["velocity"] = _tmap(torch.zeros_like, params)
        return st

    def get_learning_rate(self, state):
        return _current_lr(self, state)

    def update(self, grads, params, state):
        fn = fused_sgd_update if self.fused else fused_sgd_update_plain
        _, vel = fn(params, grads, state.get("velocity"),
                    clr=self.get_learning_rate(state), momentum=self.momentum,
                    dampening=self.dampening, nesterov=self.nesterov,
                    weight_decay=self.weight_decay)
        new_state = {"step": state["step"] + 1}
        if vel is not None:
            new_state["velocity"] = vel
        return params, new_state


class Adam(OptimMethod):
    """optim/Adam.scala, in the reference's op order."""

    weight_decay = 0.0      # AdamW's decoupled decay; none for Adam

    def __init__(self, learning_rate=1e-3, learning_rate_decay=0.0,
                 beta1=0.9, beta2=0.999, epsilon=1e-8,
                 learning_rate_schedule=None, fused=False):
        self.lr = learning_rate
        self.lr_decay = learning_rate_decay
        self.beta1, self.beta2, self.eps = beta1, beta2, epsilon
        self.schedule = learning_rate_schedule or Default()
        self.fused = bool(fused)

    def init_state(self, params):
        return {**super().init_state(params),
                "m": _tmap(torch.zeros_like, params),
                "v": _tmap(torch.zeros_like, params)}

    def get_learning_rate(self, state):
        return _current_lr(self, state)

    def update_scalars(self, state):
        """The keyword arguments of one leaf's update at ``state["step"]``:
        the device scalars ``clr``, ``bc1 = 1 - beta1^t`` and
        ``bc2 = 1 - beta2^t`` (t = step + 1, in fp32 as the reference
        computes them) and the host constants."""
        t = state["step"] + 1
        tf = t.to(torch.float32)
        b1 = torch.full((), self.beta1, dtype=torch.float32, device=t.device)
        b2 = torch.full((), self.beta2, dtype=torch.float32, device=t.device)
        return dict(clr=self.get_learning_rate(state),
                    bc1=1.0 - torch.pow(b1, tf), bc2=1.0 - torch.pow(b2, tf),
                    beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                    weight_decay=self.weight_decay)

    def update(self, grads, params, state):
        kw = self.update_scalars(state)
        m, v = state["m"], state["v"]
        fn = fused_adam_update if self.fused else fused_adam_update_plain
        fn(params, grads, m, v, **kw)
        return params, {"step": state["step"] + 1, "m": m, "v": v}


class AdamW(Adam):
    """Adam with decoupled weight decay: after the Adam step,
    ``p -= clr * weight_decay * p_old`` (in the fused case, in the same
    kernel pass)."""

    def __init__(self, learning_rate=1e-3, weight_decay=0.01, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.weight_decay = weight_decay


def _zeros_state(params, *names):
    dev = _device_of(params)
    st = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
    for n in names:
        st[n] = _tmap(torch.zeros_like, params)
    return st


def _decayed_lr(method, step):
    """``lr / (1 + step * lr_decay)``: an fp32 device scalar."""
    return method.lr / (1.0 + step * method.lr_decay)


def _pow_t(base: float, t):
    """``base ** t`` for the fp32 step ``t``, as the reference computes a
    bias correction."""
    return torch.pow(torch.full((), base, dtype=torch.float32,
                                device=t.device), t.to(torch.float32))


def _norm(x):
    return torch.sqrt(torch.sum(torch.square(x.float())))


class Adagrad(OptimMethod):
    """optim/Adagrad.scala."""

    def __init__(self, learning_rate=1e-3, learning_rate_decay=0.0,
                 weight_decay=0.0):
        self.lr = learning_rate
        self.lr_decay = learning_rate_decay
        self.weight_decay = weight_decay

    def init_state(self, params):
        return _zeros_state(params, "accum")

    def update(self, grads, params, state):
        step = state["step"]
        clr = _decayed_lr(self, step)

        def upd(p, g, a):
            if self.weight_decay > 0:
                g = g + self.weight_decay * p
            _write(a, a + g * g)
            _write(p, p - clr * g / (torch.sqrt(a) + 1e-10))
        for leaves in zip_leaves(params, grads, state["accum"]):
            upd(*leaves)
        return params, {"step": step + 1, "accum": state["accum"]}


class Adadelta(OptimMethod):
    """optim/Adadelta.scala (decay rate rho, epsilon)."""

    def __init__(self, decay_rate=0.9, epsilon=1e-10):
        self.rho = decay_rate
        self.eps = epsilon

    def init_state(self, params):
        return _zeros_state(params, "accum_g", "accum_dx")

    def update(self, grads, params, state):
        rho, eps = self.rho, self.eps

        def upd(p, g, ag, adx):
            _write(ag, rho * ag + (1 - rho) * g * g)
            dx = -g * torch.sqrt(adx + eps) / torch.sqrt(ag + eps)
            _write(adx, rho * adx + (1 - rho) * dx * dx)
            _write(p, p + dx)
        for leaves in zip_leaves(params, grads, state["accum_g"],
                                 state["accum_dx"]):
            upd(*leaves)
        return params, {"step": state["step"] + 1,
                        "accum_g": state["accum_g"],
                        "accum_dx": state["accum_dx"]}


class Adamax(OptimMethod):
    """optim/Adamax.scala."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-38):
        self.lr = learning_rate
        self.beta1, self.beta2, self.eps = beta1, beta2, epsilon

    def init_state(self, params):
        return _zeros_state(params, "m", "u")

    def update(self, grads, params, state):
        t = state["step"] + 1
        lr_bc = self.lr / (1.0 - _pow_t(self.beta1, t))
        b1, b2 = self.beta1, self.beta2

        def upd(p, g, m, u):
            _write(m, b1 * m + (1 - b1) * g)
            _write(u, torch.maximum(b2 * u, torch.abs(g) + self.eps))
            _write(p, p - lr_bc * m / u)
        for leaves in zip_leaves(params, grads, state["m"], state["u"]):
            upd(*leaves)
        return params, {"step": t, "m": state["m"], "u": state["u"]}


class RMSprop(OptimMethod):
    """optim/RMSprop.scala."""

    def __init__(self, learning_rate=1e-2, learning_rate_decay=0.0,
                 decay_rate=0.99, epsilon=1e-8):
        self.lr = learning_rate
        self.lr_decay = learning_rate_decay
        self.rho = decay_rate
        self.eps = epsilon

    def init_state(self, params):
        return _zeros_state(params, "accum")

    def update(self, grads, params, state):
        step = state["step"]
        clr = _decayed_lr(self, step)
        rho = self.rho

        def upd(p, g, a):
            _write(a, rho * a + (1 - rho) * g * g)
            _write(p, p - clr * g / (torch.sqrt(a) + self.eps))
        for leaves in zip_leaves(params, grads, state["accum"]):
            upd(*leaves)
        return params, {"step": step + 1, "accum": state["accum"]}


class Ftrl(OptimMethod):
    """FTRL-proximal (optim/Ftrl.scala)."""

    def __init__(self, learning_rate=1e-3, learning_rate_power=-0.5,
                 initial_accumulator_value=0.1, l1_regularization_strength=0.0,
                 l2_regularization_strength=0.0,
                 l2_shrinkage_regularization_strength=0.0):
        self.lr = learning_rate
        self.lr_power = learning_rate_power
        self.init_accum = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength
        self.l2_shrinkage = l2_shrinkage_regularization_strength

    def init_state(self, params):
        st = _zeros_state(params, "linear")
        st["accum"] = _tmap(lambda p: torch.full_like(p, self.init_accum),
                            params)
        return st

    def update(self, grads, params, state):
        pw = -self.lr_power

        def upd(p, g, a, lin):
            gs = g + 2 * self.l2_shrinkage * p
            a2 = a + g * g
            sigma = (a2 ** pw - a ** pw) / self.lr
            _write(lin, lin + gs - sigma * p)
            quad = a2 ** pw / self.lr + 2 * self.l2
            pre = torch.clamp(lin, -self.l1, self.l1) - lin
            _write(p, torch.where(torch.abs(lin) > self.l1, pre / quad,
                                  torch.zeros_like(p)))
            _write(a, a2)
        for leaves in zip_leaves(params, grads, state["accum"],
                                 state["linear"]):
            upd(*leaves)
        return params, {"step": state["step"] + 1, "accum": state["accum"],
                        "linear": state["linear"]}


class LBFGS(OptimMethod):
    """L-BFGS with an Armijo backtracking line search (optim/LBFGS.scala).

    Host-driven, as the reference's: the history is sequential and each
    iteration reads the loss on the host (``float``) to test sufficient
    decrease and convergence.  Only the stateful :meth:`optimize`
    interface, like the reference."""

    def __init__(self, max_iter=20, max_eval=None, tolerance_fun=1e-5,
                 tolerance_x=1e-9, n_correction=100, learning_rate=1.0,
                 line_search=False):
        self.max_iter = max_iter
        self.max_eval = max_eval or int(max_iter * 1.25)
        self.tol_fun = tolerance_fun
        self.tol_x = tolerance_x
        self.m = n_correction
        self.lr = learning_rate

    def optimize(self, feval, x):
        flat = [leaf for (leaf,) in zip_leaves(x)]
        shapes = [p.shape for p in flat]
        sizes = [p.numel() for p in flat]

        def pack(leaves):
            return torch.cat([leaf.reshape(-1) for leaf in leaves])

        def unpack(vec):
            out, off = [], 0
            for shape, n in zip(shapes, sizes):
                out.append(vec[off:off + n].reshape(shape))
                off += n
            return _unflatten(x, out)

        def f(vec):
            loss, grad = feval(unpack(vec))
            return loss, pack([g for (g,) in zip_leaves(grad)])

        xv = pack(flat)
        loss, g = f(xv)
        losses = [float(loss)]
        s_hist, y_hist, rho_hist = [], [], []
        for _ in range(self.max_iter):
            # two-loop recursion
            q = -g
            alphas = []
            for s, y, rho in zip(reversed(s_hist), reversed(y_hist),
                                 reversed(rho_hist)):
                a = rho * torch.dot(s, q)
                alphas.append(a)
                q = q - a * y
            if y_hist:
                gamma = (torch.dot(s_hist[-1], y_hist[-1])
                         / torch.clamp(torch.dot(y_hist[-1], y_hist[-1]),
                                       min=1e-10))
                q = q * gamma
            for (s, y, rho), a in zip(zip(s_hist, y_hist, rho_hist),
                                      reversed(alphas)):
                b = rho * torch.dot(y, q)
                q = q + (a - b) * s
            d = q
            # Armijo backtracking (≙ LineSearch.scala lswolfe's
            # sufficient-decrease half): monotone descent
            gd = float(torch.dot(g, d))
            t = self.lr
            loss_new, g_new = f(xv + t * d)
            while (float(loss_new) > float(loss) + 1e-4 * t * gd
                   and t > 1e-10):
                t *= 0.5
                loss_new, g_new = f(xv + t * d)
            x_new = xv + t * d
            s = x_new - xv
            y = g_new - g
            ys = torch.dot(y, s)
            if float(ys) > 1e-10:
                if len(s_hist) >= self.m:
                    s_hist.pop(0)
                    y_hist.pop(0)
                    rho_hist.pop(0)
                s_hist.append(s)
                y_hist.append(y)
                rho_hist.append(1.0 / ys)
            delta = abs(float(loss_new) - float(loss))
            xv, g, loss = x_new, g_new, loss_new
            losses.append(float(loss))
            self.nevals += 1
            if (delta < self.tol_fun
                    or float(torch.max(torch.abs(t * d))) < self.tol_x):
                break
        return unpack(xv), losses


class LARS(OptimMethod):
    """Layer-wise Adaptive Rate Scaling (You et al. 2017): each tensor's
    step scaled by trust * ||w|| / (||g|| + wd * ||w||), with momentum."""

    def __init__(self, learning_rate=1e-1, momentum=0.9, weight_decay=1e-4,
                 trust_coefficient=1e-3, epsilon=1e-9,
                 learning_rate_schedule=None):
        self.lr = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.trust = trust_coefficient
        self.eps = epsilon
        self.schedule = learning_rate_schedule or Default()

    def init_state(self, params):
        return _zeros_state(params, "velocity")

    def get_learning_rate(self, state):
        return _fill(self.schedule.rate(self, state["step"]), state["step"])

    def update(self, grads, params, state):
        step = state["step"]
        clr = self.get_learning_rate(state)
        wd = self.weight_decay

        def upd(p, g, v):
            g = g.float()
            pf = p.float()
            wn, gn = _norm(pf), _norm(g)
            g = g + wd * pf
            ratio = torch.where((wn > 0) & (gn > 0),
                                self.trust * wn / (gn + wd * wn + self.eps),
                                torch.ones_like(wn))
            _write(v, self.momentum * v + clr * ratio * g)
            _write(p, (pf - v).to(p.dtype))
        for leaves in zip_leaves(params, grads, state["velocity"]):
            upd(*leaves)
        return params, {"step": step + 1, "velocity": state["velocity"]}


class LAMB(OptimMethod):
    """Layer-wise adaptive Adam (You et al. 2019): a per-tensor trust
    ratio on bias-corrected Adam with decoupled weight decay."""

    def __init__(self, learning_rate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, weight_decay=0.01,
                 learning_rate_schedule=None):
        self.lr = learning_rate
        self.beta1, self.beta2, self.eps = beta1, beta2, epsilon
        self.weight_decay = weight_decay
        self.schedule = learning_rate_schedule or Default()

    def init_state(self, params):
        return _zeros_state(params, "m", "v")

    def get_learning_rate(self, state):
        return _fill(self.schedule.rate(self, state["step"]), state["step"])

    def update(self, grads, params, state):
        step = state["step"]
        t = step + 1
        clr = self.get_learning_rate(state)
        b1, b2 = self.beta1, self.beta2
        bc1, bc2 = 1.0 - _pow_t(b1, t), 1.0 - _pow_t(b2, t)

        def upd(p, g, m, v):
            _write(m, b1 * m + (1 - b1) * g)
            _write(v, b2 * v + (1 - b2) * g * g)
            pf = p.float()
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) \
                + self.weight_decay * pf
            wn, un = _norm(pf), _norm(u)
            ratio = torch.where((wn > 0) & (un > 0), wn / un,
                                torch.ones_like(wn))
            _write(p, (pf - clr * ratio * u).to(p.dtype))
        for leaves in zip_leaves(params, grads, state["m"], state["v"]):
            upd(*leaves)
        return params, {"step": t, "m": state["m"], "v": state["v"]}
