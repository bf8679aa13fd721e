"""Device-mesh sharding for the VI engine.

The reference is single-process shared-memory (SURVEY.md section 2.4); the
parallel decomposition here is designed from the math instead:

  * `snp` axis: LD blocks are independent, so every [*, I] tensor (and the
    packed block buckets) shards along the SNP/block axis — the sequence-
    parallel/data-parallel analog. Cross-device communication is only the
    scalar psums of ELBO terms and the [A, K] segment sums, plus boundary
    gathers for the genome<->block permutation.
  * `comp` axis: the K mixture components are independent in all heavy
    [K, P, I] tensors and contract only in O(I) reductions — the tensor-
    parallel analog. hyper_delta and mixture_prec stay replicated.

Everything uses jax.sharding.NamedSharding under jit: XLA's SPMD
partitioner inserts the collectives (psum over ICI, all-gathers for the
permutation), and the same program runs on 1 chip or a multi-host mesh via
jax.distributed.
"""
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_snp=None, n_comp=1, devices=None):
    """Create a ('comp', 'snp') mesh over `devices`.

    Defaults to all available devices on the snp axis (block sharding
    scales with problem size; component sharding helps at very large K).
    """
    if devices is None:
        # process-major order: a contiguous slice of the snp axis then
        # maps to one process's devices, which is what the multi-host
        # loader's per-process block ownership assumes
        from vilma_tpu.parallel.distributed import \
            process_contiguous_devices
        devices = process_contiguous_devices()
    if n_snp is None:
        n_snp = len(devices) // n_comp
    devices = np.asarray(devices[:n_comp * n_snp]).reshape(n_comp, n_snp)
    return Mesh(devices, axis_names=('comp', 'snp'))


def pad_to_multiple(x, multiple, axis, fill=0.0):
    """Pad `axis` of x up to a multiple (host-side, for even sharding)."""
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - size)
    return np.pad(x, widths, constant_values=fill)


def _specs(comp):
    """PartitionSpecs keyed by (owner dataclass, field) — keying on the
    owner prevents silent mis-sharding should two dataclasses ever reuse a
    field name with a different layout (see engine.ModelData /
    engine.VIState / sigma.SigmaSummaries / blocks.BlockBucket field
    comments for shapes)."""
    return {
        # ModelData [P, I] arrays
        ('ModelData', 'marginal_effects'): P(None, 'snp'),
        ('ModelData', 'std_errs'): P(None, 'snp'),
        ('ModelData', 'scalings'): P(None, 'snp'),
        ('ModelData', 'ld_diags'): P(None, 'snp'),
        ('ModelData', 'scaled_ld_diags'): P(None, 'snp'),
        ('ModelData', 'adj_marginal_effects'): P(None, 'snp'),
        ('ModelData', 'inverse_betas'): P(None, 'snp'),
        ('ModelData', 'annotations'): P('snp'),
        ('ModelData', 'chi_stat'): P(),
        ('ModelData', 'ld_ranks'): P(),
        ('ModelData', 'annotation_counts'): P(),
        ('ModelData', 'mixture_prec'): P(comp),
        ('ModelData', 'log_det'): P(comp),
        # VIState
        ('VIState', 'vi_mu'): P(comp, None, 'snp'),
        ('VIState', 'nat_mu'): P(None, 'snp'),
        ('VIState', 'nat_hist'): P(None, None, 'snp'),
        ('VIState', 'nat_hist_scale'): P(),
        ('VIState', 'nat_hist_c'): P(),
        ('VIState', 'nat_hist_n'): P(),
        ('VIState', 'vi_delta'): P(comp, 'snp'),
        ('VIState', 'hyper_delta'): P(None, comp),
        ('VIState', 'error_scaling'): P(),
        ('VIState', 'nat_grad_vi_delta'): P(None, 'snp'),
        ('VIState', 'L'): P(),
        ('VIState', 'elbo'): P(),
        ('VIState', 'running_elbo_delta'): P(),
        ('VIState', 'num_err'): P(),
        # SigmaSummaries
        ('SigmaSummaries', 'log_det_sigma'): P(comp, 'snp'),
        ('SigmaSummaries', 'sigma_summary'): P(comp, 'snp'),
        ('SigmaSummaries', 'diag'): P(comp, None, 'snp'),
        ('SigmaSummaries', 'matches'): P(comp, 'snp'),
        # PackedLD buckets: shard the block axis
        ('BlockBucket', 'u'): P('snp'),
        ('BlockBucket', 'grows'): P('snp'),
        ('BlockBucket', 'srows'): P('snp'),
        ('BlockBucket', 's'): P('snp'),
        ('BlockBucket', 'inv_s'): P('snp'),
        ('BlockBucket', 'd'): P('snp'),
        ('BlockBucket', 'perm'): P('snp'),
        ('BlockBucket', 'seq'): P('snp'),
    }


def _shard_dataclass(obj, mesh):
    import dataclasses
    has_comp = mesh.shape['comp'] > 1
    specs = _specs('comp' if has_comp else None)
    owner = type(obj).__name__
    updates = {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if isinstance(val, jax.Array) and not val.is_fully_addressable:
            # already a global (multi-host) array with jit-propagated
            # sharding; cross-process resharding via device_put is not a
            # thing, and downstream jits accept any input sharding
            continue
        if isinstance(val, jax.Array) or isinstance(val, np.ndarray):
            if isinstance(val, jax.Array) and jax.process_count() > 1:
                # local jax.Arrays cannot be device_put onto a global
                # mesh; round-trip through the (identical-per-process)
                # host value instead
                val = np.asarray(val)
            spec = specs.get((owner, f.name), P())
            if (owner, f.name) == ('VIState', 'nat_mu') and val.ndim == 3:
                # scale_se fits carry per-component [K, P, I] natural
                # means (engine.VIState docstring) — same layout as vi_mu
                spec = specs[('VIState', 'vi_mu')]
            sharding = NamedSharding(mesh, spec)
            arr = np.asarray(val)
            if (jax.process_count() > 1 and arr.dtype.kind == 'f'
                    and np.isnan(arr).any()):
                # multi-process device_put equality-checks host inputs
                # across processes, and NaN != NaN; materialize NaN
                # sentinels (e.g. VIState.running_elbo_delta) as jit
                # constants instead
                updates[f.name] = jax.jit(
                    lambda a=arr: jax.numpy.asarray(a),
                    out_shardings=sharding)()
            else:
                updates[f.name] = jax.device_put(val, sharding)
        elif dataclasses.is_dataclass(val):
            updates[f.name] = _shard_dataclass(val, mesh)
        elif isinstance(val, tuple) and val and dataclasses.is_dataclass(
                val[0]):
            updates[f.name] = tuple(_shard_dataclass(v, mesh) for v in val)
    return dataclasses.replace(obj, **updates)


def shard_data(data, mesh):
    """Place a ModelData pytree onto the mesh with engine shardings.

    Note: bucket block counts and the I axis need not be divisible by the
    mesh — XLA pads uneven shards — but even divisions avoid stragglers.
    """
    return _shard_dataclass(data, mesh)


def shard_state(state, mesh):
    """Place a VIState pytree onto the mesh with engine shardings."""
    return _shard_dataclass(state, mesh)
