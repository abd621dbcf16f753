"""A numpy copy of scikit-learn 1.9's ``MLPRegressor`` and ``MLPClassifier``
fit and predict, for the settings the yardstick scorers use and nothing
more: ReLU hidden layers, the adam solver at lr 1e-3 (β 0.9, 0.999, ε
1e-8), L2 ``alpha`` 1e-4, batches of min(200, n), a shuffle per epoch,
``tol`` 1e-4 with ``n_iter_no_change`` 10 on the training loss (no early
stopping); ``hidden_layer_sizes``, ``max_iter`` and ``random_state`` as
given.

The scorers' targets were measured with scikit-learn, and the card's
machine need not have it, so this copy repeats its arithmetic step for
step: the same ``RandomState`` draws in the same order (Glorot-uniform
coefficients, then intercepts, per layer; then one permutation of the
sample order per epoch, composed with the last), the same operand types
(float32 input stays float32, and Adam's bias-corrected step size is a
float64 scalar, so each update is formed in float64 and rounded into the
float32 parameter), the L2 term added to the summed gradient before it is
divided by the batch size, ε outside the root of the uncorrected second
moment, and the loss accumulated as numpy float32 scalars.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
from scipy.special import xlogy


def _batches(n: int, size: int):
    start = 0
    for _ in range(n // size):
        yield slice(start, start + size)
        start += size
    if start < n:
        yield slice(start, n)


def _softmax(a: np.ndarray):
    tmp = a - a.max(axis=1)[:, np.newaxis]
    np.exp(tmp, out=a)
    a /= a.sum(axis=1)[:, np.newaxis]


#: scikit-learn's defaults, which the scorers keep
ALPHA = 1e-4                 # L2 penalty
LEARNING_RATE = 1e-3
BETA_1, BETA_2, EPSILON = 0.9, 0.999, 1e-8
TOL, N_ITER_NO_CHANGE = 1e-4, 10


class _MLP:
    """The shared fit: forward, loss, backward and Adam of sklearn's
    ``BaseMultilayerPerceptron`` with ``solver='adam'``. Inputs are float32
    or float64 arrays."""

    output = "identity"

    def __init__(self, hidden_layer_sizes: Sequence[int], max_iter: int,
                 random_state: int):
        self.hidden_layer_sizes = tuple(hidden_layer_sizes)
        self.max_iter, self.random_state = int(max_iter), random_state

    # -- the network -------------------------------------------------------
    def _forward(self, x: np.ndarray) -> List[np.ndarray]:
        acts = [x]
        last = len(self.coefs_) - 1
        for i, (w, b) in enumerate(zip(self.coefs_, self.intercepts_)):
            a = acts[-1] @ w
            a += b
            if i != last:
                np.maximum(a, 0, out=a)
            elif self.output == "softmax":
                _softmax(a)
            acts.append(a)
        return acts

    def _loss(self, y, out):
        if self.output == "softmax":
            eps = np.finfo(out.dtype).eps
            out = np.clip(out, eps, 1 - eps)
            return -np.average(xlogy(y, out), axis=0).sum()
        return 0.5 * np.average((y - out) ** 2, axis=0).mean()

    def _backprop(self, x, y):
        """(loss, coefficient gradients, intercept gradients) of a batch."""
        n = x.shape[0]
        acts = self._forward(x)
        loss = self._loss(y, acts[-1])
        values = 0
        for w in self.coefs_:
            w = w.ravel()
            values += np.dot(w, w)
        loss += (0.5 * ALPHA) * values / n
        layers = len(self.coefs_)
        dcoef, dint = [None] * layers, [None] * layers
        delta = acts[-1] - y
        for i in range(layers - 1, -1, -1):
            dcoef[i] = acts[i].T @ delta
            dcoef[i] += ALPHA * self.coefs_[i]
            dcoef[i] /= n
            dint[i] = np.sum(delta, axis=0) / n
            if i:
                delta = delta @ self.coefs_[i].T
                delta[acts[i] == 0] = 0
        return loss, dcoef, dint

    def _init_params(self, units: List[int], dtype):
        self.coefs_, self.intercepts_ = [], []
        for fan_in, fan_out in zip(units[:-1], units[1:]):
            bound = np.sqrt(6.0 / (fan_in + fan_out))
            w = self._rs.uniform(-bound, bound, (fan_in, fan_out))
            b = self._rs.uniform(-bound, bound, fan_out)
            self.coefs_.append(w.astype(dtype, copy=False))
            self.intercepts_.append(b.astype(dtype, copy=False))

    def _fit(self, x: np.ndarray, y: np.ndarray):
        if y.ndim == 1:
            y = y.reshape((-1, 1))
        n = x.shape[0]
        self.n_outputs_ = y.shape[1]
        self._rs = np.random.RandomState(self.random_state)
        self._init_params([x.shape[1], *self.hidden_layer_sizes,
                           self.n_outputs_], x.dtype)
        params = self.coefs_ + self.intercepts_
        ms = [np.zeros_like(p) for p in params]
        vs = [np.zeros_like(p) for p in params]
        t = 0
        batch = min(200, n)
        order = np.arange(n, dtype=int)
        self.loss_curve_, best, stale = [], np.inf, 0
        self.n_iter_ = 0
        for _ in range(self.max_iter):
            perm = np.arange(n)
            self._rs.shuffle(perm)
            order = order[perm]
            total = 0.0
            for sl in _batches(n, batch):
                idx = order[sl]
                loss, dcoef, dint = self._backprop(x[idx], y[idx])
                total += loss * (sl.stop - sl.start)
                t += 1
                grads = dcoef + dint
                ms = [BETA_1 * m + (1 - BETA_1) * g
                      for m, g in zip(ms, grads)]
                vs = [BETA_2 * v + (1 - BETA_2) * (g ** 2)
                      for v, g in zip(vs, grads)]
                lr = (LEARNING_RATE * np.sqrt(1 - BETA_2 ** t)
                      / (1 - BETA_1 ** t))
                for p, m, v in zip(params, ms, vs):
                    p += -lr * m / (np.sqrt(v) + EPSILON)
            self.n_iter_ += 1
            self.loss_ = total / n
            self.loss_curve_.append(self.loss_)
            stale = stale + 1 if self.loss_ > best - TOL else 0
            best = min(best, self.loss_)
            if stale > N_ITER_NO_CHANGE:
                break
        return self


class MLPRegressor(_MLP):
    """Squared-error regression with an identity output."""

    def fit(self, x, y) -> "MLPRegressor":
        return self._fit(np.asarray(x), np.asarray(y))

    def predict(self, x) -> np.ndarray:
        out = self._forward(np.asarray(x))[-1]
        return out.ravel() if out.shape[1] == 1 else out


class MLPClassifier(_MLP):
    """Multiclass (three or more classes) classification with a softmax
    output and the log loss, targets one-hot as booleans."""

    output = "softmax"

    def fit(self, x, y) -> "MLPClassifier":
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if len(self.classes_) < 3:
            raise ValueError("MLPClassifier here takes three or more "
                             f"classes, got {len(self.classes_)}")
        onehot = y[:, None] == self.classes_[None, :]
        return self._fit(np.asarray(x), onehot)

    def predict_proba(self, x) -> np.ndarray:
        return self._forward(np.asarray(x))[-1]

    def predict(self, x) -> np.ndarray:
        return self.classes_.take(self.predict_proba(x).argmax(axis=1))

    def score(self, x, y) -> float:
        return float(np.mean(self.predict(x) == np.asarray(y)))
