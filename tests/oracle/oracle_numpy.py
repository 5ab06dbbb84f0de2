"""NumPy oracle encoding the reference semantics of scikit-kge.

`/root/reference` was an EMPTY mount at survey time (SURVEY.md section 0), so
this module is the executable parity target for the JAX framework: it
re-derives, in plain NumPy and from the documented behavior in SURVEY.md
sections 2-3, the math of the upstream `skge` package (mnick/scikit-kge, of
which unmeshvrije/scikit-kge is a fork). It is written from the survey's
semantic description, not copied from any source tree.

Semantics encoded here (with SURVEY.md citations):

- triple order is (subject, object, predicate) -- skge/util.py unzip_triples
  (~50), SURVEY.md section 1 "note the (s, o, p) order".
- cconv/ccorr via FFT -- skge/util.py ~15-20.
- grad_sum_matrix AVERAGES gradients over duplicate indices (divide by
  occurrence count), it does not sum -- skge/util.py ~30, SURVEY.md section
  3.1.
- pairwise trainer updates only on margin violations; if a batch has none,
  the whole batch is skipped -- skge/base.py ~265 / model _pairwise_gradients.
- HolE applies sigmoid to scores BEFORE the margin test and chains through
  Sigmoid.g_given_f -- skge/hole.py ~70. TransE compares raw scores --
  skge/transe.py ~45. (RESCAL/ER-MLP pairwise transform is [M] confidence;
  this oracle uses raw scores for TransE/RESCAL and sigmoid for HolE/ER-MLP's
  default af only where documented -- see each model.)
- AdaGrad: p2[idx] += g*g; param[idx] -= lr * g / max(sqrt(p2[idx]), EPS)
  -- skge/param.py ~75.
- normless1 post-constraint renormalizes only touched rows whose L2 norm
  exceeds 1 -- skge/param.py ~110 [M].
- L2 regularization (rparam) is added to the AVERAGED gradient at each unique
  touched row: g += rparam * param[unique_idx] -- skge/hole.py gradients.
- pointwise logistic loss: sum(logaddexp(0, -y*f)); gradient prefactor
  fs = -y * sigmoid(-y*f) -- skge/base.py ~180 / skge/hole.py ~40.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-6  # AdaGrad denominator guard (skge/param.py _EPS, [M] exact value)


# ---------------------------------------------------------------------------
# util.py equivalents
# ---------------------------------------------------------------------------

def cconv(a, b):
    """Circular convolution, batched on leading dims (skge/util.py ~15)."""
    return np.fft.ifft(np.fft.fft(a) * np.fft.fft(b)).real


def ccorr(a, b):
    """Circular correlation, batched on leading dims (skge/util.py ~20)."""
    return np.fft.ifft(np.conj(np.fft.fft(a)) * np.fft.fft(b)).real


def grad_sum_matrix(idx):
    """Duplicate-index averaging helper (skge/util.py ~30).

    Returns (unique_idx, M, n) where M is a dense {0,1} matrix of shape
    (n_unique, len(idx)) summing duplicate occurrences and n the per-unique
    occurrence counts. The reference uses scipy.sparse CSR; dense is fine for
    an oracle.
    """
    idx = np.asarray(idx)
    uidx, inv = np.unique(idx, return_inverse=True)
    M = np.zeros((uidx.size, idx.size))
    M[inv, np.arange(idx.size)] = 1.0
    n = M.sum(axis=1)[:, None]
    return uidx, M, n


def unzip_triples(xys, with_ys=False):
    """Split [(s, o, p), ...] or [((s, o, p), y), ...] into arrays.

    Triple order is (s, o, p) -- skge/util.py ~50.
    """
    if with_ys:
        xs = np.array([x for x, _ in xys], dtype=np.int64)
        ys = np.array([y for _, y in xys], dtype=np.float64)
        return xs[:, 0], xs[:, 1], xs[:, 2], ys
    xs = np.array(list(xys), dtype=np.int64)
    return xs[:, 0], xs[:, 1], xs[:, 2]


# ---------------------------------------------------------------------------
# actfun.py equivalents
# ---------------------------------------------------------------------------

class Linear:
    @staticmethod
    def f(x):
        return x

    @staticmethod
    def g_given_f(fx):
        return np.ones_like(fx)


class Sigmoid:
    @staticmethod
    def f(x):
        return 1.0 / (1.0 + np.exp(-x))

    @staticmethod
    def g_given_f(fx):
        return fx * (1.0 - fx)


class Tanh:
    @staticmethod
    def f(x):
        return np.tanh(x)

    @staticmethod
    def g_given_f(fx):
        return 1.0 - fx * fx


class ReLU:
    @staticmethod
    def f(x):
        return np.maximum(x, 0.0)

    @staticmethod
    def g_given_f(fx):
        return (fx > 0).astype(fx.dtype)


# ---------------------------------------------------------------------------
# param.py equivalents
# ---------------------------------------------------------------------------

def normless1(param, idx):
    """Project touched rows onto the unit L2 ball (skge/param.py ~110 [M])."""
    rows = param[idx]
    norm = np.sqrt(np.sum(rows ** 2, axis=-1, keepdims=True))
    param[idx] = np.where(norm > 1.0, rows / np.maximum(norm, 1e-30), rows)


class AdaGradOracle:
    """Sparse AdaGrad (skge/param.py ~75): accumulate only at touched rows."""

    def __init__(self, param, lr=0.1, post=None):
        self.param = param
        self.lr = lr
        self.p2 = np.zeros_like(param)
        self.post = post

    def update(self, g, idx):
        self.p2[idx] += g * g
        H = np.maximum(np.sqrt(self.p2[idx]), EPS)
        self.param[idx] -= self.lr * g / H
        if self.post is not None:
            self.post(self.param, idx)


class SGDOracle:
    def __init__(self, param, lr=0.1, post=None):
        self.param = param
        self.lr = lr
        self.post = post

    def update(self, g, idx):
        self.param[idx] -= self.lr * g
        if self.post is not None:
            self.post(self.param, idx)


# ---------------------------------------------------------------------------
# Models. Each returns gradients as {param_name: (grad_rows, unique_idx)} for
# row params and {param_name: grad} for dense params, exactly mirroring the
# reference's _gradients/_pairwise_gradients contract (SURVEY.md section 2.1).
# ---------------------------------------------------------------------------

def _logistic_prefactor(ys, scores):
    """fs = -y * sigmoid(-y*f); loss = sum(logaddexp(0, -y*f))."""
    yf = ys * scores
    loss = np.sum(np.logaddexp(0.0, -yf))
    fs = -(ys * Sigmoid.f(-yf))[:, None]
    return loss, fs


class TransEOracle:
    """skge/transe.py. Pairwise-only model; E rows constrained to unit ball.

    score = -||E[s] + R[p] - E[o]||_{1 or 2}  (l2 variant is the SQUARED
    distance, [M]); no rparam regularization.
    """

    def __init__(self, E, R, l1=True, margin=1.0):
        self.E = E
        self.R = R
        self.l1 = l1
        self.margin = margin

    def scores(self, ss, os_, ps):
        d = self.E[ss] + self.R[ps] - self.E[os_]
        if self.l1:
            return -np.sum(np.abs(d), axis=1)
        return -np.sum(d ** 2, axis=1)

    def pairwise_gradients(self, pxs, nxs):
        sp, op_, pp = unzip_triples(pxs)
        sn, on_, pn = unzip_triples(nxs)
        pscores = self.scores(sp, op_, pp)
        nscores = self.scores(sn, on_, pn)
        ind = np.where(nscores + self.margin > pscores)[0]
        nviolations = ind.size
        if nviolations == 0:
            return None, 0
        sp, op_, pp = sp[ind], op_[ind], pp[ind]
        sn, on_, pn = sn[ind], on_[ind], pn[ind]
        dp = self.E[sp] + self.R[pp] - self.E[op_]
        dn = self.E[sn] + self.R[pn] - self.E[on_]
        if self.l1:
            gp, gn = np.sign(dp), np.sign(dn)
        else:
            gp, gn = 2.0 * dp, 2.0 * dn
        # d loss / d f_p = -1, d loss / d f_n = +1 for violating pairs.
        # f = -dist so d f / d e_s = -(d dist/d e_s) etc.
        ge_sp = gp          # -1 * -(+g)
        ge_op = -gp
        ge_sn = -gn
        ge_on = gn
        gr_pp = gp
        gr_pn = -gn
        eidx, Me, ne = grad_sum_matrix(np.concatenate([sp, sn, op_, on_]))
        ge = Me.dot(np.vstack([ge_sp, ge_sn, ge_op, ge_on])) / ne
        ridx, Mr, nr = grad_sum_matrix(np.concatenate([pp, pn]))
        gr = Mr.dot(np.vstack([gr_pp, gr_pn])) / nr
        return {"E": (ge, eidx), "R": (gr, ridx)}, nviolations


class HolEOracle:
    """skge/hole.py: score = sum(R[p] * ccorr(E[s], E[o]), axis=-1).

    Pointwise gradients use the ccorr/cconv adjoint identities; pairwise
    applies sigmoid before the margin test (SURVEY.md section 2.1 #8).
    """

    def __init__(self, E, R, rparam=0.0, margin=1.0, af=Sigmoid):
        self.E = E
        self.R = R
        self.rparam = rparam
        self.margin = margin
        self.af = af

    def scores(self, ss, os_, ps):
        return np.sum(self.R[ps] * ccorr(self.E[ss], self.E[os_]), axis=1)

    def gradients(self, xys):
        ss, os_, ps, ys = unzip_triples(xys, with_ys=True)
        scores = self.scores(ss, os_, ps)
        loss, fs = _logistic_prefactor(ys, scores)

        ridx, Mr, nr = grad_sum_matrix(ps)
        gr = Mr.dot(fs * ccorr(self.E[ss], self.E[os_])) / nr
        gr += self.rparam * self.R[ridx]

        eidx, Me, ne = grad_sum_matrix(np.concatenate([ss, os_]))
        ge = Me.dot(np.vstack([
            fs * ccorr(self.R[ps], self.E[os_]),   # d f / d e_s
            fs * cconv(self.E[ss], self.R[ps]),    # d f / d e_o
        ])) / ne
        ge += self.rparam * self.E[eidx]
        return {"E": (ge, eidx), "R": (gr, ridx)}, loss

    def pairwise_gradients(self, pxs, nxs):
        sp, op_, pp = unzip_triples(pxs)
        sn, on_, pn = unzip_triples(nxs)
        pscores = self.af.f(self.scores(sp, op_, pp))
        nscores = self.af.f(self.scores(sn, on_, pn))
        ind = np.where(nscores + self.margin > pscores)[0]
        nviolations = ind.size
        if nviolations == 0:
            return None, 0
        sp, op_, pp = sp[ind], op_[ind], pp[ind]
        sn, on_, pn = sn[ind], on_[ind], pn[ind]
        gpscores = -self.af.g_given_f(pscores[ind])[:, None]
        gnscores = self.af.g_given_f(nscores[ind])[:, None]

        ridx, Mr, nr = grad_sum_matrix(np.concatenate([pp, pn]))
        gr = Mr.dot(np.vstack([
            gpscores * ccorr(self.E[sp], self.E[op_]),
            gnscores * ccorr(self.E[sn], self.E[on_]),
        ])) / nr
        gr += self.rparam * self.R[ridx]

        eidx, Me, ne = grad_sum_matrix(np.concatenate([sp, sn, op_, on_]))
        ge = Me.dot(np.vstack([
            gpscores * ccorr(self.R[pp], self.E[op_]),
            gnscores * ccorr(self.R[pn], self.E[on_]),
            gpscores * cconv(self.E[sp], self.R[pp]),
            gnscores * cconv(self.E[sn], self.R[pn]),
        ])) / ne
        ge += self.rparam * self.E[eidx]
        return {"E": (ge, eidx), "R": (gr, ridx)}, nviolations


class RESCALOracle:
    """skge/rescal.py: score = e_s^T W_p e_o, W is (n_r, d, d).

    Pairwise uses raw scores ([M] -- SURVEY.md documents sigmoid only for
    HolE; the JAX framework mirrors this oracle's choice).
    """

    def __init__(self, E, W, rparam=0.0, margin=1.0):
        self.E = E
        self.W = W
        self.rparam = rparam
        self.margin = margin

    def scores(self, ss, os_, ps):
        return np.einsum("bi,bij,bj->b", self.E[ss], self.W[ps], self.E[os_])

    def _role_grads(self, ss, os_, ps, fs):
        """Per-occurrence gradients given prefactor fs (column vector)."""
        es, eo, wp = self.E[ss], self.E[os_], self.W[ps]
        g_es = fs * np.einsum("bij,bj->bi", wp, eo)
        g_eo = fs * np.einsum("bi,bij->bj", es, wp)
        g_w = fs[:, :, None] * np.einsum("bi,bj->bij", es, eo)
        return g_es, g_eo, g_w

    def gradients(self, xys):
        ss, os_, ps, ys = unzip_triples(xys, with_ys=True)
        scores = self.scores(ss, os_, ps)
        loss, fs = _logistic_prefactor(ys, scores)
        g_es, g_eo, g_w = self._role_grads(ss, os_, ps, fs)

        widx, Mw, nw = grad_sum_matrix(ps)
        gw = np.einsum("ub,bij->uij", Mw, g_w) / nw[:, :, None]
        gw += self.rparam * self.W[widx]

        eidx, Me, ne = grad_sum_matrix(np.concatenate([ss, os_]))
        ge = Me.dot(np.vstack([g_es, g_eo])) / ne
        ge += self.rparam * self.E[eidx]
        return {"E": (ge, eidx), "W": (gw, widx)}, loss

    def pairwise_gradients(self, pxs, nxs):
        sp, op_, pp = unzip_triples(pxs)
        sn, on_, pn = unzip_triples(nxs)
        pscores = self.scores(sp, op_, pp)
        nscores = self.scores(sn, on_, pn)
        ind = np.where(nscores + self.margin > pscores)[0]
        nviolations = ind.size
        if nviolations == 0:
            return None, 0
        sp, op_, pp = sp[ind], op_[ind], pp[ind]
        sn, on_, pn = sn[ind], on_[ind], pn[ind]
        one = np.ones((ind.size, 1))
        gp_es, gp_eo, gp_w = self._role_grads(sp, op_, pp, -one)
        gn_es, gn_eo, gn_w = self._role_grads(sn, on_, pn, one)

        widx, Mw, nw = grad_sum_matrix(np.concatenate([pp, pn]))
        gw = np.einsum("ub,bij->uij", Mw, np.concatenate([gp_w, gn_w])) / nw[:, :, None]
        gw += self.rparam * self.W[widx]

        eidx, Me, ne = grad_sum_matrix(np.concatenate([sp, sn, op_, on_]))
        ge = Me.dot(np.vstack([gp_es, gn_es, gp_eo, gn_eo])) / ne
        ge += self.rparam * self.E[eidx]
        return {"E": (ge, eidx), "W": (gw, widx)}, nviolations


class ERMLPOracle:
    """skge/ermlp.py: score = C . af(W^T [e_s; e_o; r_p]).

    W is (3*d, nhidden), C is (nhidden,). Param names/concat order are [M]
    (SURVEY.md section 2.1 #9); the JAX framework mirrors this oracle. Dense
    params W, C receive the masked MEAN gradient over the batch ([M] choice,
    consistent with the row-averaging semantics elsewhere). No rparam.
    """

    def __init__(self, E, R, W, C, margin=1.0, af=Sigmoid):
        self.E = E
        self.R = R
        self.W = W
        self.C = C
        self.margin = margin
        self.af = af

    def _forward(self, ss, os_, ps):
        x = np.concatenate([self.E[ss], self.E[os_], self.R[ps]], axis=1)
        h = self.af.f(x.dot(self.W))
        return x, h, h.dot(self.C)

    def scores(self, ss, os_, ps):
        return self._forward(ss, os_, ps)[2]

    def _role_grads(self, ss, os_, ps, fs):
        x, h, _ = self._forward(ss, os_, ps)
        delta = fs * self.C[None, :] * self.af.g_given_f(h)  # (B, nh)
        g_x = delta.dot(self.W.T)                            # (B, 3d)
        d = self.E.shape[1]
        g_es, g_eo, g_rp = g_x[:, :d], g_x[:, d:2 * d], g_x[:, 2 * d:]
        g_W = np.einsum("bi,bj->ij", x, delta)               # summed over batch
        g_C = (fs * h).sum(axis=0)
        return g_es, g_eo, g_rp, g_W, g_C

    def gradients(self, xys):
        ss, os_, ps, ys = unzip_triples(xys, with_ys=True)
        scores = self.scores(ss, os_, ps)
        loss, fs = _logistic_prefactor(ys, scores)
        g_es, g_eo, g_rp, g_W, g_C = self._role_grads(ss, os_, ps, fs)

        eidx, Me, ne = grad_sum_matrix(np.concatenate([ss, os_]))
        ge = Me.dot(np.vstack([g_es, g_eo])) / ne
        ridx, Mr, nr = grad_sum_matrix(ps)
        gr = Mr.dot(g_rp) / nr
        B = len(xys)
        return {"E": (ge, eidx), "R": (gr, ridx),
                "W": g_W / B, "C": g_C / B}, loss

    def pairwise_gradients(self, pxs, nxs):
        sp, op_, pp = unzip_triples(pxs)
        sn, on_, pn = unzip_triples(nxs)
        pscores = self.scores(sp, op_, pp)
        nscores = self.scores(sn, on_, pn)
        ind = np.where(nscores + self.margin > pscores)[0]
        nviolations = ind.size
        if nviolations == 0:
            return None, 0
        sp, op_, pp = sp[ind], op_[ind], pp[ind]
        sn, on_, pn = sn[ind], on_[ind], pn[ind]
        one = np.ones((ind.size, 1))
        gp = self._role_grads(sp, op_, pp, -one)
        gn = self._role_grads(sn, on_, pn, one)

        eidx, Me, ne = grad_sum_matrix(np.concatenate([sp, sn, op_, on_]))
        ge = Me.dot(np.vstack([gp[0], gn[0], gp[1], gn[1]])) / ne
        ridx, Mr, nr = grad_sum_matrix(np.concatenate([pp, pn]))
        gr = Mr.dot(np.vstack([gp[2], gn[2]])) / nr
        g_W = (gp[3] + gn[3]) / nviolations
        g_C = (gp[4] + gn[4]) / nviolations
        return {"E": (ge, eidx), "R": (gr, ridx),
                "W": g_W, "C": g_C}, nviolations
