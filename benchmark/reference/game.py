"""Plain reference for the GLMix cell: coordinate descent over a global
logistic model and a per-user random effect, from the generated rows.

The objective is
J = sum_i log(1 + exp(z_i)) - y_i z_i + λ_g/2 |w_g|^2 + λ_u/2 sum_u |w_u|^2
with z_i = x_i . w_g + u_i . w_{user(i)} (every coefficient under the L2
terms, as the program's). A sweep fits the global model given the users'
scores (``glm.py``'s objective and plain L-BFGS, with the fit's own
budget), then every user's model given the global scores, as the
program's ``CoordinateDescent`` orders them. A user's model is solved to
its optimum by Newton's method over the user's own dense rows (its
features found from the rows' ids, never from the program's projection),
the Hessian solved through the rows' small system (Woodbury). It imports
nothing of the program.

``dtype`` / ``acc`` as in ``glm.py``: float64 for the reference,
bfloat16 kept and float32 sums for the control (the small solves run in
``acc``: PyTorch has no bfloat16 solve).

The global model's fit stops on its iteration budget, far from its
optimum, and the sweeps do not reach the joint optimum, so the check
follows the program stage by stage (``judge``):

- ``loss_gap``, ``grad_gap``: the first sweep's global fit, from the
  cold model, followed through its first ``glm.FOLLOW`` iterations in
  float64, as ``glm.py`` judges a λ;
- ``global_gap``: each sweep's global fit: the value it reported against
  its objective in float64 at the model it returned, given the users'
  scores it was fitted against (the program's own, read from its
  coordinate descent), relative, the largest;
- ``re_gap``: the last sweep's users given the program's last global
  model: the users' part of J at the program's users (their scores and
  the bank's squared norm; a user's coefficients are a selection of the
  user shard's, so their norm is the same in any projection) against
  its float64 optimum, relative, either way: a part below the optimum
  is as wrong as one above it;
- ``value_gap``: the objective the program reported after its last sweep
  against J of its returned model in float64, relative.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from reference import glm

BLOCK_USERS = 8192
NEWTON_ITERS = 50
NEWTON_TOL = 1e-10  # of a user's gradient, max-abs, float64


class Rows:
    """The generated rows on the device, values in ``dtype``: the global
    shard as ``glm.Rows`` and each user's rows as dense blocks over the
    user's own features."""

    def __init__(self, data: dict, features: int, device, dtype=torch.float64):
        dev = torch.device(device)
        self.dtype = dtype
        self.features = int(features)
        self.glob = glm.Rows(data, features, dev, dtype, idx_key="g_idx", val_key="g_val")
        self.labels = self.glob.labels
        users = torch.as_tensor(data["users"]).to(dev, torch.int64)
        u_idx = torch.as_tensor(data["u_idx"]).to(dev, torch.int64)
        u_val = torch.as_tensor(data["u_val"]).to(dev, torch.float64)
        self.n = int(users.shape[0])
        self.num_users = int(users.max()) + 1
        # each user's rows, in row order: slot = the row's place among them
        order = torch.argsort(users, stable=True)
        counts = torch.bincount(users, minlength=self.num_users)
        starts = torch.cumsum(counts, 0) - counts
        self.row_user = users[order]
        self.row_slot = torch.arange(self.n, device=dev) - starts[self.row_user]
        self.order = order
        self.S = int(counts.max())
        # each user's features: the distinct ids among its rows' nonzeros
        idx, val = u_idx[order], u_val[order]
        nz = val != 0
        key = self.row_user[:, None] * self.features + idx
        uniq, inv = torch.unique(key[nz], return_inverse=True)
        first = torch.searchsorted(uniq, torch.arange(self.num_users, device=dev) * self.features)
        owner = uniq // self.features
        self.D = int(torch.bincount(owner, minlength=self.num_users).max())
        self.ent_row = torch.nonzero(nz, as_tuple=True)[0]  # entries: sorted row, feature, value
        self.ent_col = inv - first[owner[inv]]
        self.ent_val = val[nz]

    def user_block(self, a: int, b: int):
        """Users ``a .. b - 1`` as dense X [b - a, S, D] in ``dtype`` and
        each slot's row [b - a, S] (-1: none)."""
        dev = self.labels.device
        sel = (self.row_user[self.ent_row] >= a) & (self.row_user[self.ent_row] < b)
        r = self.ent_row[sel]
        X = torch.zeros(b - a, self.S, self.D, dtype=torch.float64, device=dev)
        X.index_put_((self.row_user[r] - a, self.row_slot[r], self.ent_col[sel]),
                     self.ent_val[sel], accumulate=True)
        pos = torch.full((b - a, self.S), -1, dtype=torch.int64, device=dev)
        rows = torch.nonzero((self.row_user >= a) & (self.row_user < b), as_tuple=True)[0]
        pos[self.row_user[rows] - a, self.row_slot[rows]] = self.order[rows]
        return X.to(self.dtype), pos


def _loss(z, y):
    return torch.nn.functional.softplus(z) - y * z


def _newton(X, o, y, mask, lam, w, acc):
    """Each user's model by Newton's method with a backtracking search;
    X [B, S, D], o / y / mask [B, S], w [B, D] (the start); -> (models,
    margins, each user's part of J)."""
    dtype = X.dtype
    eye = torch.eye(X.shape[1], dtype=acc, device=X.device)

    def value(v):
        z = (torch.bmm(X, v.unsqueeze(2)).squeeze(2).to(acc) + o).to(dtype)
        return ((_loss(z, y) * mask).sum(1, dtype=acc)
                + 0.5 * lam * (v.to(acc) ** 2).sum(1)), z

    f, z = value(w)
    for _ in range(NEWTON_ITERS):
        p = torch.sigmoid(z)
        r = (p - y) * mask
        g = (torch.bmm(X.transpose(1, 2), r.unsqueeze(2)).squeeze(2).to(acc) + lam * w.to(acc))
        if float(g.abs().max()) <= NEWTON_TOL:
            break
        A = X.to(acc) * torch.sqrt(p * (1 - p) * mask).to(acc).unsqueeze(2)
        M = lam * eye + torch.bmm(A, A.transpose(1, 2))
        sol = torch.linalg.solve(M, torch.bmm(A, g.unsqueeze(2)))
        step = (g - torch.bmm(A.transpose(1, 2), sol).squeeze(2)) / lam
        decrease = (g * step).sum(1)
        t = torch.ones(X.shape[0], dtype=acc, device=X.device)
        for _ in range(30):
            w_new = (w.to(acc) - t[:, None] * step).to(dtype)
            f_new, z_new = value(w_new)
            # a user already at its optimum moves by rounding alone
            slack = 16 * torch.finfo(acc).eps * f.abs()
            ok = f_new <= f - 1e-4 * t * decrease + slack
            if bool(ok.all()):
                break
            t = torch.where(ok, t, t / 2)
        keep = ok[:, None]
        w = torch.where(keep, w_new, w)
        f = torch.where(ok, f_new, f)
        z = torch.where(keep, z_new, z)
        if not bool(ok.any()):
            break
    return w, z, f


def user_solve(rows: Rows, offsets, lam, bank, acc):
    """Every user's model given the global scores ``offsets``; -> (bank
    [U, D], the users' scores in row order, the users' part of J)."""
    scores = torch.zeros(rows.n, dtype=acc, device=offsets.device)
    total = torch.zeros((), dtype=acc, device=offsets.device)
    for a in range(0, rows.num_users, BLOCK_USERS):
        b = min(a + BLOCK_USERS, rows.num_users)
        X, pos = rows.user_block(a, b)
        mask = (pos >= 0).to(rows.dtype)
        at = pos.clamp_min(0)
        o = torch.where(pos >= 0, offsets[at].to(acc), 0.0)
        y = (rows.labels[at] * mask).to(rows.dtype)
        w, z, f = _newton(X, o, y, mask, lam, bank[a:b], acc)
        bank[a:b] = w
        scores[pos[pos >= 0]] = (z.to(acc) - o)[pos >= 0]
        total = total + f.sum()
    return bank, scores, float(total)


def users_part(rows: Rows, global_scores, user_scores, bank_sq, lam_u) -> float:
    """The users' part of J (loss and their L2 term) at given scores, float64."""
    z = global_scores.to(torch.float64) + user_scores.to(rows.labels.device, torch.float64)
    return float(_loss(z, rows.labels.to(torch.float64)).sum() + 0.5 * lam_u * float(bank_sq))


def fit(rows: Rows, sweeps: int, lam_g: float, lam_u: float, global_fit: dict,
        acc=torch.float32) -> dict:
    """The reference's coordinate descent from the cold model in
    ``rows.dtype``, the global model under ``global_fit`` (``max_iter``,
    ``tolerance``, ``history``), read as ``judge`` reads a program's fit.
    The control runs it in bfloat16."""
    dev = rows.labels.device
    w = torch.zeros(rows.features, dtype=rows.dtype, device=dev)
    bank = torch.zeros(rows.num_users, rows.D, dtype=rows.dtype, device=dev)
    user_scores = torch.zeros(rows.n, dtype=acc, device=dev)
    first, global_fits = None, []
    for _ in range(sweeps):
        r = glm.minimize(rows.glob, lam_g, w, acc=acc, offsets=user_scores, **global_fit)
        w = r.w
        global_fits.append((user_scores, w, r.value))
        first = first or {"values": r.values[:glm.FOLLOW + 1], "first_grad_norm": r.first_grad_norm}
        global_sc = rows.glob.sparse.matvec(w, acc)
        bank, user_scores, users_j = user_solve(rows, global_sc, lam_u, bank, acc)
    reported = users_j + 0.5 * lam_g * float((w.to(acc) ** 2).sum())
    return {**first, "global_fits": global_fits, "global": w, "user_scores": user_scores,
            "bank_sq": float((bank.to(torch.float64) ** 2).sum()), "reported": reported}


def judge(rows: Rows, fits: List[dict], lam_g: float, lam_u: float, global_fit: dict
          ) -> Dict[str, float]:
    """``fits``: the program's fits, each {"values", "first_grad_norm" (of
    the first sweep's global fit), "global", "user_scores", "bank_sq",
    "reported"}; -> the numbers the check compares (module note)."""
    zero = torch.zeros(rows.features, dtype=torch.float64, device=rows.labels.device)
    ref = glm.minimize(rows.glob, lam_g, zero, max_iter=glm.FOLLOW, tolerance=0.0,
                       history=int(global_fit["history"]))
    out = {"loss_gap": 0.0, "grad_gap": 0.0, "global_gap": 0.0, "re_gap": 0.0, "value_gap": 0.0}
    for f in fits:
        for residual, w, reported in f["global_fits"]:
            fg = float(glm.value_grad(rows.glob, w.to(zero.device, torch.float64), lam_g,
                                      offsets=residual.to(zero.device, torch.float64))[0])
            out["global_gap"] = max(out["global_gap"], abs(reported - fg) / abs(fg))
        steps = min(len(ref.values), len(f["values"]))
        out["loss_gap"] = max(out["loss_gap"], *(
            abs(float(f["values"][i]) - ref.values[i]) / abs(ref.values[i]) for i in range(steps)))
        out["grad_gap"] = max(out["grad_gap"], abs(float(f["first_grad_norm"]) - ref.first_grad_norm)
                              / ref.first_grad_norm)
        wg = f["global"].to(zero.device, torch.float64)
        zg = rows.glob.sparse.matvec(wg, torch.float64)
        part = users_part(rows, zg, f["user_scores"], f["bank_sq"], lam_u)
        bank = torch.zeros(rows.num_users, rows.D, dtype=torch.float64, device=zero.device)
        best = user_solve(rows, zg, lam_u, bank, torch.float64)[2]
        out["re_gap"] = max(out["re_gap"], abs(part - best) / abs(best))
        j = part + 0.5 * lam_g * float((wg * wg).sum())
        out["value_gap"] = max(out["value_gap"], abs(float(f["reported"]) - j) / abs(j))
    return out
