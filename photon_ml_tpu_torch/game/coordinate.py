"""GAME coordinates: fixed effect, random effect, factored random effect
and matrix factorization (port of the single-device parts of
``photon_ml_tpu/game/coordinate.py``).

Reference: photon-ml .../algorithm/Coordinate.scala:82 (score /
initializeModel / updateModel / regTerm over its dataset),
FixedEffectCoordinate.scala:137-164, RandomEffectCoordinate.scala:104-199,
RandomEffectCoordinateInProjectedSpace.scala:30-140,
FactoredRandomEffectCoordinate.scala:99-289 (alternating latent-space RE
solves and a fit of the shared projection matrix).

The KeyValueScore residual currency is a row-aligned [n] tensor on the
dataset's device; every ``updateModel(model, partialScore)`` folds the
residual into the offsets (dataSet.addScoresToOffsets) by passing
``offsets + residual``. The fixed effect solves through its problem's
objective: the scatter objective, or the tiled one (K1 on the card), whose
schedules ``ensure_tiled`` builds once and reuses across sweeps because
every sweep's batch shares the dataset's cached feature tensors.

With a ``mesh`` (this rank's ``parallel.mesh.ProcessMesh``) the fixed
effect solves over the ranks: a (data, model) mesh runs the
feature-sharded fit of ``parallel/distributed.py`` on this rank's cell,
built once and kept on the dataset (only the row vectors a sweep changes,
the offsets and a down-sampling draw's weights, are cut to the cell anew);
a mesh with only a data axis runs the data-parallel fit on this rank's
rows. The coefficients come back whole on every rank, so scores and
residuals stay replicated.

``PodRandomEffectCoordinate`` is the entity-sharded random effect
(``game/pod.py``): its bank lives sharded over an ``entity`` mesh of ranks,
and its residuals and scores ride the two-hop all-to-all.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.data.batch import SparseBatch
from photon_ml_tpu_torch.data.sampler import down_sample, down_sample_weights
from photon_ml_tpu_torch.game.config import (
    FactoredRandomEffectConfiguration,
    ProjectorType,
    RandomEffectDataConfiguration,
)
from photon_ml_tpu_torch.game.data import GameDataset
from photon_ml_tpu_torch.game.model import (
    DatumScoringModel,
    FixedEffectModel,
    MatrixFactorizationModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.game.random_effect import (
    RandomEffectOptimizationProblem,
    device_row_view,
    score_random_effect,
)
from photon_ml_tpu_torch.game.random_effect_data import (
    RandomEffectBucket,
    RandomEffectDataset,
)
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import create_model
from photon_ml_tpu_torch.optim.common import OptResult
from photon_ml_tpu_torch.ops.tiled_sparse import (
    FeatureShardedTiledBatch,
    TiledGLMObjective,
    TiledSparseBatch,
    build_sharded_tiled_batch,
    feature_shard_tiled_batch,
)
from photon_ml_tpu_torch.optim.config import OptimizerType
from photon_ml_tpu_torch.optim.problem import _VARIANCE_EPSILON, GLMOptimizationProblem
from photon_ml_tpu_torch.parallel.distributed import (
    feature_shard_sparse_batch,
    feature_sharded_extras,
    feature_sharded_glm_fit,
    feature_sharded_hessian_diagonal,
)
from photon_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    data_shard_sparse_batch,
)

Tensor = torch.Tensor


class Coordinate:
    """One block of the coordinate descent (Coordinate.scala)."""

    name: str

    def initialize_model(self) -> DatumScoringModel:
        raise NotImplementedError

    def update_model(
        self, model: DatumScoringModel, residual: Optional[Tensor]
    ) -> Tuple[DatumScoringModel, object]:
        raise NotImplementedError

    def score(self, model: DatumScoringModel) -> Tensor:
        raise NotImplementedError

    def regularization_term(self, model: DatumScoringModel) -> float:
        return float(self.regularization_term_device(model))

    def regularization_term_device(self, model: DatumScoringModel) -> Tensor:
        """The reg term as a device scalar: the CD loop sums these into its
        one fetch per iteration."""
        raise NotImplementedError


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _cut_rows(rows: Tensor, start: int, length: int) -> Tensor:
    """``rows[start:start + length]``, zero-padded to ``length`` (a data
    shard's padded rows: weight 0, inert)."""
    out = rows.new_zeros(length)
    part = rows[start:start + length]
    out[: part.shape[0]] = part
    return out


@dataclass
class FixedEffectCoordinate(Coordinate):
    """Global GLM block (FixedEffectCoordinate.scala:137-164).
    ``sampler_seed`` seeds the down-sampling draw (``down_sampling_rate <
    1``), one ``torch.Generator`` per update. ``mesh``: this rank's
    ProcessMesh (module note); every rank of it builds the coordinate with
    the same dataset and calls ``update_model`` with the same arguments."""

    name: str
    dataset: GameDataset
    problem: GLMOptimizationProblem
    feature_shard_id: str
    reg_weight: float = 0.0
    down_sampling_rate: float = 1.0
    sampler_seed: int = 0
    mesh: Optional[object] = None

    def initialize_model(self) -> FixedEffectModel:
        dim = self.dataset.shards[self.feature_shard_id].dim
        zeros = torch.zeros(dim, device=self.dataset.device)
        return FixedEffectModel(
            create_model(self.problem.task, Coefficients(zeros)), self.feature_shard_id
        )

    def _batch(self, residual: Optional[Tensor]):
        offsets = None
        if residual is not None:
            # the residual algebra stays on the device
            offsets = self.dataset.row_tensors()[1] + residual
        return self.dataset.batch_for_shard(self.feature_shard_id, offsets)

    def _is_feature_sharded(self) -> bool:
        return self.mesh is not None and MODEL_AXIS in self.mesh.axis_names

    def update_model(self, model, residual=None):
        if self.mesh is not None:
            return self._update_model_on_mesh(model, residual)
        batch = self._batch(residual)
        initial = model.model.means if model is not None else None
        if self.down_sampling_rate < 1.0:
            coefficients, result = self.problem.run_with_sampling(
                batch, _generator(batch.device, self.sampler_seed),
                self.down_sampling_rate, initial=initial, reg_weight=self.reg_weight,
            )
        else:
            coefficients, result = self.problem.run(
                batch, initial=initial, reg_weight=self.reg_weight
            )
        return (
            FixedEffectModel(self.problem.create_model(coefficients), self.feature_shard_id),
            result,
        )

    # -- over a mesh --------------------------------------------------------

    def _rows(self, residual):
        """The update's (offsets, weights) over every row: the residual
        folded in, the down-sampling draw applied."""
        labels, offsets, weights = self.dataset.row_tensors()
        if residual is not None:
            offsets = offsets + residual
        if self.down_sampling_rate < 1.0:
            weights = down_sample_weights(
                _generator(weights.device, self.sampler_seed), labels, weights,
                self.down_sampling_rate, self.problem.task,
            )
        return offsets, weights

    def _mesh_state(self) -> dict:
        """This rank's layout and fit builders, made once. The layout
        depends on the shard, the mesh's shape and this rank's place in it
        and the kernel, not on the optimizer, so it is kept on the dataset
        (one entry a feature shard) and a grid of combos lays out once."""
        state = self.__dict__.get("_mesh_state_cache")
        if state is not None:
            return state
        mesh, problem = self.mesh, self.problem
        dim = self.dataset.shards[self.feature_shard_id].dim
        tiled = isinstance(problem.objective, TiledGLMObjective)
        sharded = self._is_feature_sharded()
        layouts = self.dataset.__dict__.setdefault("_fs_layout_cache", {})
        key = (
            self.feature_shard_id, tuple(mesh.shape), tuple(mesh.axis_names),
            tuple(mesh.coords), tiled,
        )
        layout = layouts.get(key)
        if layout is None:
            base = self.dataset.batch_for_shard(self.feature_shard_id)
            d_shards = mesh.size(DATA_AXIS)
            d_index = mesh.index(DATA_AXIS)
            if sharded:
                args = (base, dim, d_shards, mesh.size(MODEL_AXIS), d_index,
                        mesh.index(MODEL_AXIS))
                cell, block_dim = (
                    feature_shard_tiled_batch(
                        *args, device=mesh.device,
                        builders=mesh.ranks_sharing((DATA_AXIS, MODEL_AXIS)),
                    ) if tiled else feature_shard_sparse_batch(*args, device=mesh.device)
                )
            elif tiled:
                cell = build_sharded_tiled_batch(
                    base, dim, d_shards, d_index, device=mesh.device,
                    builders=mesh.ranks_sharing((DATA_AXIS,)),
                )
                block_dim = dim
            else:
                cell, block_dim = None, dim  # cut from the batch each update
            for k in [k for k in layouts if k[0] == self.feature_shard_id]:
                del layouts[k]
            layout = layouts[key] = (cell, block_dim)
        cell, block_dim = layout
        state = dict(cell=cell, dim=dim)
        if sharded:
            use_owlqn = problem.regularization.has_l1
            d_pad = mesh.size(MODEL_AXIS) * block_dim
            extras_tail, l1_mask, with_norm = feature_sharded_extras(
                dim, d_pad, normalization=problem.objective.norm, box=problem.box,
                use_owlqn=use_owlqn, intercept_index=problem.intercept_index,
                device=mesh.device,
            )
            use_tron = problem.config.optimizer_type == OptimizerType.TRON
            state.update(
                d_pad=d_pad, extras_tail=extras_tail, l1_mask=l1_mask,
                norm_extras=extras_tail[:2] if with_norm else [],
                fit=feature_sharded_glm_fit(
                    problem.objective, mesh,
                    optimizer="tron" if use_tron else ("owlqn" if use_owlqn else "lbfgs"),
                    max_iter=problem.config.max_iter, tol=problem.config.tolerance,
                    history=problem.config.lbfgs_history,
                    max_cg=problem.config.tron_max_cg, with_norm=with_norm,
                    with_box=problem.box is not None,
                ),
                hdiag=(
                    feature_sharded_hessian_diagonal(
                        problem.objective, mesh, with_norm=with_norm
                    )
                    if problem.compute_variances else None
                ),
            )
        self.__dict__["_mesh_state_cache"] = state
        return state

    def _cell_rows(self, residual):
        """This rank's cell with the update's row vectors."""
        st = self._mesh_state()
        offsets, weights = self._rows(residual)
        cell, mesh = st["cell"], self.mesh
        d_shards, d_index = mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)
        if cell is None:  # the data-parallel scatter fit: this rank's rows
            batch = self.dataset.batch_for_shard(self.feature_shard_id, offsets)
            return data_shard_sparse_batch(
                replace(batch, weights=weights), d_shards, d_index
            )
        if isinstance(cell, TiledSparseBatch):  # the data-parallel tiled fit
            R = cell.num_rows
            return replace(
                cell, offsets=_cut_rows(offsets, d_index * R, R),
                weights=_cut_rows(weights, d_index * R, R),
            )
        if isinstance(cell, FeatureShardedTiledBatch):
            R = cell.meta.rows_per_shard
            return replace(cell, cell=replace(
                cell.cell, offsets=_cut_rows(offsets, d_index * R, R),
                weights=_cut_rows(weights, d_index * R, R),
            ))
        n_loc = cell.batch.num_rows
        return replace(cell, batch=replace(
            cell.batch, offsets=_cut_rows(offsets, d_index * n_loc, n_loc),
            weights=_cut_rows(weights, d_index * n_loc, n_loc),
        ))

    def _update_model_on_mesh(self, model, residual):
        st = self._mesh_state()
        cell = self._cell_rows(residual)
        initial = model.model.means if model is not None else None
        if not self._is_feature_sharded():  # the data-parallel solve
            coefficients, result = self.problem.run(
                cell, initial=initial, reg_weight=self.reg_weight, mesh=self.mesh
            )
        else:
            dim = st["dim"]
            w0 = torch.zeros(st["d_pad"], device=self.mesh.device)
            if initial is not None:
                w0[:dim] = initial
            l1, l2 = self.problem.regularization.split(self.reg_weight)
            extras = (
                [l1, st["l1_mask"]] if st["l1_mask"] is not None else []
            ) + st["extras_tail"]
            result = st["fit"](w0, cell, l2, *extras)
            variances = None
            if st["hdiag"] is not None:
                hd = st["hdiag"](result.coefficients, cell, l2, *st["norm_extras"])
                variances = (1.0 / (hd + _VARIANCE_EPSILON))[:dim]
            coefficients = Coefficients(result.coefficients[:dim], variances)
            result = replace(result, coefficients=coefficients.means)
        return (
            FixedEffectModel(self.problem.create_model(coefficients), self.feature_shard_id),
            result,
        )

    def prepare(self, model=None) -> None:
        """Stage the solve's static inputs ahead of ``update_model``: this
        rank's layout on a mesh, else the shard's device columns."""
        if self.mesh is not None:
            self._mesh_state()
        else:
            self.dataset.batch_for_shard(self.feature_shard_id)

    def update_model_grid(self, reg_weights):
        """Every grid weight in one solve over a [G, d] bank
        (``problem.run_grid``: K2 when the problem is tiled), cold starts
        per member; the down-sampling draw is λ-independent, so the whole
        grid solves against one sampled batch. -> [(FixedEffectModel,
        OptResult), ...] aligned with ``reg_weights``."""
        if self.mesh is not None:
            # the grid over a mesh solves member by member, cold, on the
            # rank's cached layout
            out = []
            for w in reg_weights:
                solver = replace(self, reg_weight=float(w))
                solver.__dict__["_mesh_state_cache"] = self._mesh_state()
                out.append(solver.update_model(None))
            return out
        batch = self._batch(None)
        if self.down_sampling_rate < 1.0:
            batch = down_sample(
                _generator(batch.device, self.sampler_seed), batch,
                self.down_sampling_rate, self.problem.task,
            )
        variances, result = self.problem.run_grid(batch, [float(w) for w in reg_weights])
        out = []
        for i in range(len(reg_weights)):
            var_i = variances[i] if variances is not None else None
            coefficients = Coefficients(result.coefficients[i], var_i)
            member: OptResult = result.member(i)
            out.append((
                FixedEffectModel(
                    self.problem.create_model(coefficients), self.feature_shard_id
                ),
                member,
            ))
        return out

    def score(self, model: FixedEffectModel) -> Tensor:
        return model.score(self.dataset)

    def regularization_term_device(self, model: FixedEffectModel) -> Tensor:
        l1, l2 = self.problem.regularization.split(self.reg_weight)
        w = model.model.means
        term = 0.5 * l2 * (w * w).sum()
        if l1:
            term = term + l1 * w.abs().sum()
        return term


@dataclass
class RandomEffectCoordinate(Coordinate):
    """Per-entity block (RandomEffectCoordinate[InProjectedSpace])."""

    name: str
    dataset: GameDataset
    re_dataset: RandomEffectDataset
    problem: RandomEffectOptimizationProblem

    def _zeros(self) -> Tensor:
        return torch.zeros(
            self.re_dataset.num_entities, self.re_dataset.local_dim,
            device=self.re_dataset.device,
        )

    def initialize_model(self) -> RandomEffectModel:
        return RandomEffectModel(
            self._zeros(),
            self.re_dataset,
            self.re_dataset.config.random_effect_type,
            self.re_dataset.config.feature_shard_id,
        )

    def update_model(self, model, residual=None):
        offsets = self.dataset.row_tensors()[1]
        if residual is not None:
            offsets = offsets + residual
        variances = None
        if self.problem.compute_variances:
            bank, tracker, variances = self.problem.update_bank(
                model.bank, self.re_dataset, residual_offsets=offsets,
                with_variances=True, defer_tracker=True,
            )
        else:
            bank, tracker = self.problem.update_bank(
                model.bank, self.re_dataset, residual_offsets=offsets,
                defer_tracker=True,
            )
        return replace(model, bank=bank, variances=variances), tracker

    def score(self, model: RandomEffectModel) -> Tensor:
        return score_random_effect(model.bank, self.re_dataset)

    def regularization_term_device(self, model: RandomEffectModel) -> Tensor:
        return self.problem.regularization_term_device(model.bank)


def _latent_scores(bank: Tensor, projection: Tensor, re_dataset: RandomEffectDataset) -> Tensor:
    """Row-aligned scores of a factored model: x_lat_i . bank[entity_i]
    with x_lat_i = sum_s v_s B[ix_s]."""
    codes, valid, ix, v = device_row_view(re_dataset)
    x_lat = _latent_rows(projection, ix, v)
    return torch.where(valid, (x_lat * bank[codes]).sum(dim=-1), 0.0)


def _latent_rows(projection: Tensor, ix: Tensor, v: Tensor) -> Tensor:
    """Every row projected into latent space: sum_s v_s B[ix_s] -> [n, L]
    (the reference's einsum over a gather)."""
    return torch.einsum("nk,nkl->nl", v.to(projection.dtype), projection[ix])


@dataclass
class FactoredRandomEffectCoordinate(Coordinate):
    """Random effects in a learned latent projection: alternate (1)
    per-entity solves in latent space and (2) a fit of the shared
    projection matrix B [d, L] (FactoredRandomEffectCoordinate.scala:
    99-289)."""

    name: str
    dataset: GameDataset
    re_dataset: RandomEffectDataset  # IDENTITY-projected base view
    problem: RandomEffectOptimizationProblem
    projection_problem: GLMOptimizationProblem  # over flattened B
    config: FactoredRandomEffectConfiguration
    reg_weight_projection: float = 0.0
    seed: int = 0

    def initialize_model(self) -> "FactoredRandomEffectModel":
        d = self.re_dataset.local_dim
        L = self.config.latent_space_dimension
        # the reference's numpy draw, so both packages start from one B
        rng = np.random.default_rng(self.seed)
        projection = rng.normal(0.0, 1.0 / np.sqrt(L), size=(d, L)).astype(np.float32)
        dev = self.re_dataset.device
        return FactoredRandomEffectModel(
            bank=torch.zeros(self.re_dataset.num_entities, L, device=dev),
            projection=torch.as_tensor(projection, device=dev),
            re_dataset=self.re_dataset,
            random_effect_type=self.re_dataset.config.random_effect_type,
            feature_shard_id=self.re_dataset.config.feature_shard_id,
        )

    def update_model(self, model, residual=None):
        offsets = self.dataset.row_tensors()[1]
        if residual is not None:
            offsets = offsets + residual
        bank, projection = model.bank, model.projection
        tracker = None
        _, _, ix, v = device_row_view(self.re_dataset)
        for _ in range(self.config.num_inner_iterations):
            # (1) latent-space per-entity solves over re-projected buckets
            x_lat = _latent_rows(projection, ix, v).cpu().numpy()
            bank, tracker = self.problem.update_bank(
                bank, _latent_view(self.re_dataset, x_lat),
                residual_offsets=offsets, defer_tracker=True,
            )
            # (2) the projection fit: a GLM over vec(B) whose row features
            # are outer(x_i, w_e(i)) flattened to d*L
            projection = self._update_projection(bank, projection, offsets)
        return replace(model, bank=bank, projection=projection), tracker

    def projection_batch(self, bank: Tensor, offsets: Tensor) -> SparseBatch:
        """The projection fit's rows: index j*L + l, value v_s * w_l."""
        L = self.config.latent_space_dimension
        codes, valid, ix, v = device_row_view(self.re_dataset)
        w_rows = bank[codes]  # [n, L]
        n, k = ix.shape
        lanes = torch.arange(L, device=ix.device)
        flat_ix = (ix[:, :, None] * L + lanes).reshape(n, k * L)
        flat_v = (v.to(bank.dtype)[:, :, None] * w_rows[:, None, :]).reshape(n, k * L)
        lab, _, w = self.dataset.row_tensors()
        return SparseBatch(
            indices=flat_ix.to(torch.int32),
            values=torch.where(valid[:, None], flat_v, 0.0),
            labels=lab, offsets=offsets, weights=w,
        )

    def _update_projection(self, bank: Tensor, projection: Tensor, offsets: Tensor) -> Tensor:
        coefficients, _ = self.projection_problem.run(
            self.projection_batch(bank, offsets),
            initial=projection.reshape(-1),
            reg_weight=self.reg_weight_projection,
        )
        return coefficients.means.reshape(projection.shape)

    def score(self, model) -> Tensor:
        return _latent_scores(model.bank, model.projection, self.re_dataset)

    def regularization_term_device(self, model) -> Tensor:
        # the bank only, as the reference counts it
        return self.problem.regularization_term_device(model.bank)


@dataclass
class FactoredRandomEffectModel(DatumScoringModel):
    """Latent bank [E, L] + shared projection [d, L]
    (FactoredRandomEffectModel.scala:75)."""

    bank: Tensor
    projection: Tensor
    re_dataset: RandomEffectDataset
    random_effect_type: str
    feature_shard_id: str

    def score(self, dataset: GameDataset) -> Tensor:
        return _latent_scores(self.bank, self.projection, self.re_dataset)


def _latent_view(base: RandomEffectDataset, x_lat: np.ndarray) -> RandomEffectDataset:
    """A RandomEffectDataset's rows re-projected into latent space: dense
    identity-local features of width L, the same entity grouping and
    buckets (built on the host as the reference builds them)."""
    L = x_lat.shape[1]
    n = base.row_local_indices.shape[0]
    row_ix = np.tile(np.arange(L, dtype=np.int32)[None, :], (n, 1))
    buckets = []
    for b in base.buckets:
        safe = np.maximum(b.row_index, 0)
        bix = np.tile(
            np.arange(L, dtype=np.int32)[None, None, :], (b.num_entities, b.capacity, 1)
        )
        bv = x_lat[safe].astype(np.float32)
        bv = np.where((b.row_index >= 0)[:, :, None], bv, 0.0)
        buckets.append(replace(b, indices=bix, values=bv, identity_indices=True))
    return replace(
        base,
        local_dim=L,
        projection=np.tile(np.arange(L, dtype=np.int32)[None, :], (base.num_entities, 1)),
        row_local_indices=row_ix,
        row_local_values=x_lat.astype(np.float32),
        buckets=buckets,
        random_projection=None,
    )


@dataclass
class MatrixFactorizationCoordinate(Coordinate):
    """MF block trained by alternating least squares on residuals: row
    factors solve a K-dim GLM whose features are colLatent[col_i] (a
    random-effect solve in disguise), then the columns symmetrically.
    Photon ML scores external MF models (MatrixFactorizationModel.scala);
    the JAX package trains them in-tree, and so does the port."""

    name: str
    dataset: GameDataset
    row_effect_type: str
    col_effect_type: str
    num_latent_factors: int
    problem: RandomEffectOptimizationProblem
    num_inner_iterations: int = 1
    seed: int = 0

    def initialize_model(self) -> MatrixFactorizationModel:
        # the reference's numpy draws, so both packages start alike
        rng = np.random.default_rng(self.seed)
        R = self.dataset.entity_indexes[self.row_effect_type].num_entities
        C = self.dataset.entity_indexes[self.col_effect_type].num_entities
        K = self.num_latent_factors
        dev = self.dataset.device
        return MatrixFactorizationModel(
            self.row_effect_type,
            self.col_effect_type,
            torch.as_tensor(rng.normal(0, 0.1, size=(R, K)).astype(np.float32), device=dev),
            torch.as_tensor(rng.normal(0, 0.1, size=(C, K)).astype(np.float32), device=dev),
        )

    def _side_structure(self, side: str, solve_codes, fixed_codes, num_solved):
        """Static ALS half-step structure of one side: entity grouping,
        bucket membership and per-bucket partner gather plans. It depends
        only on the dataset's entity codes, so it is built once per side
        and cached; per half-step only the latent values change, and those
        are gathered on the device (:meth:`_als_side`)."""
        cache = self.__dict__.setdefault("_als_structure_cache", {})
        hit = cache.get(side)
        if hit is not None:
            return hit

        K = self.num_latent_factors
        dev = self.dataset.device
        real = (self.dataset.weights > 0) & (solve_codes >= 0) & (fixed_codes >= 0)

        # vectorized entity grouping: stable-sort the rows by entity, then
        # scatter each cap class's grouped rows into its padded [E_b, S]
        # block with one flat assignment
        real_idx = np.nonzero(real)[0]
        codes_real = solve_codes[real_idx].astype(np.int64)
        order = np.argsort(codes_real, kind="stable")
        sorted_rows = real_idx[order]
        counts = np.bincount(codes_real, minlength=num_solved)
        starts = np.cumsum(counts) - counts
        caps = np.where(
            counts > 0,
            1 << np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64),
            0,
        )
        # merge sparse cap classes upward: keep a class only when it holds
        # >= 25% of the active entities (the largest is always kept; an
        # entity never pads down), every other class pads up to the next
        # kept one, and no entity pads more than 4x its own cap (a
        # heavy-tailed count distribution would otherwise collapse the
        # merge onto the largest class)
        active = caps > 0
        if active.any():
            classes, class_counts = np.unique(caps[active], return_counts=True)
            total_active = int(class_counts.sum())
            kept = {
                int(c) for c, cnt in zip(classes, class_counts)
                if cnt >= 0.25 * total_active
            }
            kept.add(int(classes.max()))
            for c in sorted((int(c) for c in classes), reverse=True):
                target = min((k for k in kept if k >= c), default=None)
                if target is None or target > 4 * c:
                    kept.add(c)
            kept = np.asarray(sorted(kept), np.int64)
            caps[active] = kept[np.searchsorted(kept, caps[active])]
        buckets = []
        gather_plans = []  # (partner codes [E_b, S], ok [E_b, S]) on the device
        for S in sorted(set(int(c) for c in caps if c > 0)):
            members = np.nonzero(caps == S)[0]
            E_b = len(members)
            lens = counts[members]
            total = int(lens.sum())
            intra = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
            src = sorted_rows[np.repeat(starts[members], lens) + intra]
            b_rows = np.full((E_b, S), -1, np.int32)
            b_rows.flat[np.repeat(np.arange(E_b) * S, lens) + intra] = src
            safe = np.maximum(b_rows, 0)
            ok = b_rows >= 0
            buckets.append(RandomEffectBucket(
                entity_codes=members.astype(np.int32),
                row_index=b_rows,
                indices=np.tile(np.arange(K, dtype=np.int32)[None, None, :], (E_b, S, 1)),
                # zero-width placeholder: every update passes
                # values_override, and the override path never reads it
                values=np.zeros((E_b, S, 0), np.float32),
                labels=np.where(ok, self.dataset.labels[safe], 0.0),
                offsets=np.where(ok, self.dataset.offsets[safe], 0.0),
                weights=np.where(ok, self.dataset.weights[safe], 0.0),
                identity_indices=True,
            ))
            gather_plans.append((
                torch.as_tensor(np.where(ok, fixed_codes[safe], 0), device=dev).long(),
                torch.as_tensor(ok, device=dev),
            ))
        view = RandomEffectDataset(
            config=RandomEffectDataConfiguration(
                random_effect_type="__mf__",
                feature_shard_id="__latent__",
                projector_type=ProjectorType.IDENTITY,
            ),
            num_entities=num_solved,
            local_dim=K,
            projection=np.tile(np.arange(K, dtype=np.int32)[None, :], (num_solved, 1)),
            # zero-length row-level placeholders: update_bank never reads
            # them (scores go through MatrixFactorizationModel.score)
            row_local_indices=np.zeros((0, K), np.int32),
            row_local_values=np.zeros((0, K), np.float32),
            row_entity_codes=np.where(real, solve_codes, -1).astype(np.int32),
            buckets=buckets,
            num_active_rows=int(counts.sum()),
            num_passive_rows=0,
            device=dev,
        )
        cache[side] = (view, gather_plans)
        return cache[side]

    def _als_side(
        self, side: str, solve_codes: np.ndarray, fixed_codes: np.ndarray,
        fixed_latent: Tensor, bank: Tensor, offsets: Optional[Tensor], num_solved: int,
    ) -> Tensor:
        """One ALS half-step: the solved side's bank against the partner
        side's factors, gathered on the device one bucket at a time (a
        callable per bucket: only the bucket being solved holds its
        gathered values)."""
        view, gather_plans = self._side_structure(side, solve_codes, fixed_codes, num_solved)
        K = fixed_latent.shape[1]

        def gather(codes: Tensor, ok: Tensor):
            def values() -> Tensor:
                rows = fixed_latent.index_select(0, codes.reshape(-1)).view(*codes.shape, K)
                return torch.where(ok[..., None], rows, 0.0)
            return values

        new_bank, _ = self.problem.update_bank(
            bank, view, residual_offsets=offsets,
            values_override=[gather(codes, ok) for codes, ok in gather_plans],
        )
        return new_bank

    def update_model(self, model, residual=None):
        rows = self.dataset.entity_codes[self.row_effect_type]
        cols = self.dataset.entity_codes[self.col_effect_type]
        R = self.dataset.entity_indexes[self.row_effect_type].num_entities
        C = self.dataset.entity_indexes[self.col_effect_type].num_entities
        row_latent, col_latent = model.row_latent, model.col_latent
        # with no residual the buckets' own offsets are the dataset's, so
        # no per-bucket gather of the offsets is needed
        offsets = None
        if residual is not None:
            offsets = self.dataset.row_tensors()[1] + residual
        if not self.__dict__.get("_als_prewarmed"):
            row_view, _ = self._side_structure("row", rows, cols, R)
            col_view, _ = self._side_structure("col", cols, rows, C)
            self.problem.prewarm([
                (row_latent, row_view, True, offsets is not None),
                (col_latent, col_view, True, offsets is not None),
            ])
            self.__dict__["_als_prewarmed"] = True
        for _ in range(self.num_inner_iterations):
            row_latent = self._als_side("row", rows, cols, col_latent, row_latent, offsets, R)
            col_latent = self._als_side("col", cols, rows, row_latent, col_latent, offsets, C)
        return replace(model, row_latent=row_latent, col_latent=col_latent), None

    def score(self, model: MatrixFactorizationModel) -> Tensor:
        return model.score(self.dataset)

    def regularization_term_device(self, model: MatrixFactorizationModel) -> Tensor:
        _, l2 = self.problem.regularization.split(self.problem.reg_weight)
        return 0.5 * l2 * (
            (model.row_latent * model.row_latent).sum()
            + (model.col_latent * model.col_latent).sum()
        )


@dataclass
class PodRandomEffectCoordinate(Coordinate):
    """Entity-sharded random-effect block (pod-scale GAME, ``game/pod.py``):
    the bank, variances and per-entity data shard over the ``entity`` mesh
    axis by entity hash, each rank solves only its own entities, and the
    residual currency rides a two-hop all-to-all (residuals in, scores
    out). Model state is a PodRandomEffectModel whose whole ``bank``
    materializes lazily (export and validation only). Every rank of the
    mesh drives it together."""

    name: str
    dataset: GameDataset
    re_dataset: RandomEffectDataset
    problem: RandomEffectOptimizationProblem  # mesh-less base
    mesh: object = None  # 1-D entity mesh (required)

    def __post_init__(self):
        from photon_ml_tpu_torch.game.pod import PodRandomEffectProblem

        if self.mesh is None:
            raise ValueError("PodRandomEffectCoordinate requires an entity mesh")
        self.pod = PodRandomEffectProblem(self.problem, self.mesh)

    def _model(self, bank, variances=None):
        from photon_ml_tpu_torch.game.pod import PodRandomEffectModel

        return PodRandomEffectModel(
            bank, self.re_dataset, self.re_dataset.config.random_effect_type,
            self.re_dataset.config.feature_shard_id, variances_sharded=variances,
        )

    def initialize_model(self):
        return self._model(self.pod.init_bank(self.re_dataset))

    def update_model(self, model, residual=None):
        offsets = self.dataset.row_tensors()[1]
        if residual is not None:
            offsets = offsets + residual  # stays on the device
        bank = getattr(model, "sharded_bank", None)
        if bank is None and model is not None:
            bank = model.bank  # warm start from a whole model
        variances = None
        if self.problem.compute_variances:
            bank, tracker, variances = self.pod.update_bank(
                bank, self.re_dataset, residual_offsets=offsets,
                with_variances=True, defer_tracker=True,
            )
        else:
            bank, tracker = self.pod.update_bank(
                bank, self.re_dataset, residual_offsets=offsets, defer_tracker=True,
            )
        return self._model(bank, variances), tracker

    def score(self, model) -> Tensor:
        bank = getattr(model, "sharded_bank", None)
        if bank is None:
            return score_random_effect(model.bank, self.re_dataset)
        return self.pod.score(bank, self.re_dataset)

    def regularization_term_device(self, model) -> Tensor:
        bank = getattr(model, "sharded_bank", None)
        if bank is None:
            bank = model.bank
        return self.pod.regularization_term_device(bank)

    def prepare(self, model=None) -> None:
        self.pod.prepare(self.re_dataset)
