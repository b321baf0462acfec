"""``LBFGS`` (counterpart of ``paddle_tpu/optimizer/lbfgs.py``): full-batch
quasi-Newton over the parameters as one flat fp32 vector, with the
two-loop recursion over a history of ``history_size`` (s, y) pairs and,
for ``line_search_fn="strong_wolfe"``, the reference's backtracking
(Armijo) search of up to 10 halvings; without it, one step of
``learning_rate``. ``step(closure)`` runs up to ``max_iter`` iterations,
each re-evaluating ``closure()`` (which computes the loss and calls
``backward()``); the scalars of the recursion are read to the host, as in
the reference.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from .optimizer import Optimizer

__all__ = ["LBFGS"]


def _host(x) -> float:
    """A loss or a dot product read to the host."""
    return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)


class LBFGS(Optimizer):
    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._max_iter = max_iter
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history = history_size
        self._line_search = line_search_fn
        self._s: List[torch.Tensor] = []
        self._y: List[torch.Tensor] = []
        self._prev_flat_g: Optional[torch.Tensor] = None
        self._prev_flat_p: Optional[torch.Tensor] = None

    def _gather_grads(self) -> torch.Tensor:
        """The clipped gradients (zeros for a parameter without one), in
        fp32 with L2 decay folded in, as one vector."""
        params = self._params()
        grads = self._clip(params, [p.grad for p in params])
        flat = []
        for p, g in zip(params, grads):
            g = (torch.zeros(p.shape, device=p.device) if g is None
                 else g.float())
            if self._l2_coeff:
                g = g + self._l2_coeff * p.detach().float()
            flat.append(g.reshape(-1))
        return torch.cat(flat)

    def _set_params(self, flat: torch.Tensor):
        off = 0
        for p in self._params():
            n = p.numel()
            p.data = flat[off:off + n].reshape(p.shape).to(p.dtype)
            off += n

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        """Up to ``max_iter`` iterations (one call is a whole inner
        optimization, as in the reference); returns the last loss."""
        if closure is None:
            raise ValueError("LBFGS.step requires a closure computing the "
                             "loss with backward()")
        with torch.enable_grad():
            loss = closure()
        for _ in range(self._max_iter):
            loss, converged = self._iterate(loss, closure)
            if converged:
                break
        return loss

    def _iterate(self, loss, closure):
        flat_g = self._gather_grads()
        flat_p = torch.cat([p.detach().float().reshape(-1)
                            for p in self._params()])
        if _host(flat_g.abs().max()) <= self._tol_grad:
            return loss, True
        if self._prev_flat_g is not None:
            s = flat_p - self._prev_flat_p
            y = flat_g - self._prev_flat_g
            if float(s @ y) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self._history:
                    self._s.pop(0)
                    self._y.pop(0)
        q = flat_g
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / float(s @ y)
            a = rho * float(s @ q)
            alphas.append((a, rho, s, y))
            q = q - a * y
        if self._s:
            s, y = self._s[-1], self._y[-1]
            q = q * (float(s @ y) / float(y @ y))
        for a, rho, s, y in reversed(alphas):
            b = rho * float(y @ q)
            q = q + (a - b) * s
        direction = -q
        f0 = _host(loss)
        g_dot_d = float(flat_g @ direction)
        t = self.get_lr()
        for _ in range(10 if self._line_search else 1):
            self._set_params(flat_p + t * direction)
            if not self._line_search:
                break
            self.clear_grad()
            with torch.enable_grad():
                f_new = _host(closure())
            if f_new <= f0 + 1e-4 * t * g_dot_d:
                break
            t *= 0.5
        self._prev_flat_g = flat_g
        self._prev_flat_p = flat_p
        self._step_count += 1
        self.clear_grad()
        with torch.enable_grad():
            new_loss = closure()
        converged = (abs(_host(new_loss) - f0) < self._tol_change
                     or t * _host(direction.abs().max()) < self._tol_change)
        return new_loss, converged

    def clear_state(self):
        self._s.clear()
        self._y.clear()
        self._prev_flat_g = self._prev_flat_p = None
