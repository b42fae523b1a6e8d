"""The logical-axis layer: one mesh factory and one rules table, the
port of ``horovod_tpu.parallel.logical``.

* **One vocabulary.** The physical axis names live here: the flat data
  axis (``DATA_AXIS``), the fast intra-host axis (``ICI_AXIS``, NVLink
  on the card) and the slow inter-host axis (``DCN_AXIS``, InfiniBand),
  and the spelling of each parallelism role (``ROLE_AXES``).
* **One mesh factory.** :class:`LogicalMesh` lays a ``dp=8,tp=4``-style
  axis stack over the ranks. Where the ranks span more than one host it
  splits the stack at the host boundary (the leading axes across hosts,
  the rest inside one), through
  :func:`~horovod_tpu_torch.parallel.mesh.hybrid_mesh`; on one host it is
  a plain :func:`~horovod_tpu_torch.parallel.mesh.make_mesh`.
* **One rules table.** Logical tensor-dimension names (``batch``,
  ``heads``, ``mlp``, ...) map to physical axes through an ordered rules
  table; a rule whose physical axis the mesh lacks resolves to
  replicated.

A :class:`LogicalMesh` holds its **rank grid**, an integer array in the
JAX package's device order, and needs no process group until its
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
is asked for (``.mesh``, built on first use, by every rank in the same
order). :meth:`LogicalMesh.spec` returns a tuple of physical axis names
(or ``None``), entry for entry the JAX ``PartitionSpec``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

from horovod_tpu_torch.common.exceptions import InvalidArgumentError

#: The flat data-parallel axis of the default 1-D mesh (every card a rank).
DATA_AXIS = "hvd"
#: Fast-domain axis of the hybrid mesh (within one host, NVLink).
ICI_AXIS = "ici"
#: Slow-domain axis of the hybrid mesh (across hosts, InfiniBand).
DCN_AXIS = "dcn"

#: Physical axis spelling per parallelism role.
ROLE_AXES: Dict[str, str] = {
    "data": "dp",
    "tensor": "tp",
    "seq": "sp",
    "stage": "pp",
    "expert": "ep",
}

#: Unbound fallback per role: ``data`` falls back to the flat axis.
_LEGACY_ROLE_AXES: Dict[str, str] = dict(ROLE_AXES, data=DATA_AXIS)

#: The default logical-axis rules table. Ordered: the first rule whose
#: physical axis the mesh defines wins; a ``None`` axis is replicated.
DEFAULT_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("batch", ROLE_AXES["data"]),
    ("batch", DATA_AXIS),
    ("heads", ROLE_AXES["tensor"]),
    ("kv", None),
    ("embed", None),
    ("mlp", ROLE_AXES["tensor"]),
    ("vocab", ROLE_AXES["tensor"]),
    ("seq", ROLE_AXES["seq"]),
    ("expert", ROLE_AXES["expert"]),
    ("stage", ROLE_AXES["stage"]),
)

#: Logical axis names each role may carry collectives for.
_ROLE_LOGICAL: Dict[str, Tuple[str, ...]] = {
    "data": ("batch",),
    "tensor": ("heads", "mlp", "vocab"),
    "seq": ("seq",),
    "stage": ("stage",),
    "expert": ("expert",),
}

#: Canonical axis order of the config string (unknown axes sort after,
#: alphabetically).
_CANONICAL_ORDER: Tuple[str, ...] = (
    ROLE_AXES["data"], ROLE_AXES["tensor"], ROLE_AXES["seq"],
    ROLE_AXES["stage"], ROLE_AXES["expert"], DATA_AXIS, ICI_AXIS,
    DCN_AXIS)


def parse_mesh_config(config: str) -> Dict[str, int]:
    """Parse ``"dp=8,tp=4,sp=2"`` into an ordered ``{axis: size}`` dict;
    ``-1`` is the wildcard of :func:`~horovod_tpu_torch.parallel.mesh.
    make_mesh` (at most one)."""
    axes: Dict[str, int] = {}
    if not isinstance(config, str) or not config.strip():
        raise InvalidArgumentError(
            f"empty mesh config (expected e.g. 'dp=8,tp=4'): {config!r}")
    for part in config.split(","):
        part = part.strip()
        if "=" not in part:
            raise InvalidArgumentError(
                f"mesh config entry {part!r} is not name=size "
                f"(in {config!r})")
        name, _, size_s = part.partition("=")
        name = name.strip()
        if not name.isidentifier():
            raise InvalidArgumentError(
                f"mesh axis name {name!r} is not an identifier "
                f"(in {config!r})")
        if name in axes:
            raise InvalidArgumentError(
                f"duplicate mesh axis {name!r} in {config!r}")
        try:
            size = int(size_s.strip())
        except ValueError:
            raise InvalidArgumentError(
                f"mesh axis size {size_s!r} is not an integer "
                f"(in {config!r})") from None
        if size < 1 and size != -1:
            raise InvalidArgumentError(
                f"mesh axis {name}={size} must be >= 1 (or -1 wildcard)")
        axes[name] = size
    return axes


def format_mesh_config(axes: Dict[str, int]) -> str:
    """``{axis: size}`` as the canonical config string: known axes in
    dp/tp/sp/pp/ep order, unknown axes after them alphabetically."""
    def key(name: str):
        try:
            return (0, _CANONICAL_ORDER.index(name), name)
        except ValueError:
            return (1, 0, name)

    return ",".join(f"{n}={int(axes[n])}" for n in sorted(axes, key=key))


class LogicalMesh:
    """One physical mesh over the ranks and one logical-axis rules table.

    ``axes`` maps physical axis name -> size, major to minor (``-1``
    wildcard). ``ranks`` are the ranks to lay out (default: every rank
    of the process group, or rank 0 without one) and ``domains`` each
    rank's host key (default: the gathered hostnames,
    :func:`~horovod_tpu_torch.parallel.mesh.rank_domains`). Where the
    ranks span several hosts, the leading axes go across hosts until
    they multiply to the host count and the rest tile one host; on one
    host the axes lay out over the first ``prod(axes)`` ranks."""

    def __init__(self, axes: Dict[str, int], *,
                 rules: Sequence[Tuple[str, Optional[str]]] = DEFAULT_RULES,
                 ranks: Optional[Sequence[int]] = None,
                 domains: Optional[Sequence] = None):
        from horovod_tpu_torch.parallel import mesh as _mesh

        if not axes:
            raise InvalidArgumentError("LogicalMesh needs at least one axis")
        self.rules: Tuple[Tuple[str, Optional[str]], ...] = tuple(
            (str(l), p) for l, p in rules)
        ranks = list(ranks) if ranks is not None else _mesh.world_ranks()
        domains = (list(domains) if domains is not None
                   else _mesh.rank_domains(ranks))
        sizes = self._resolve_wildcard(dict(axes), len(ranks))
        want = math.prod(sizes.values())
        if want > len(ranks):
            raise InvalidArgumentError(
                f"mesh axes {format_mesh_config(sizes)} need {want} "
                f"device(s) but only {len(ranks)} are available")
        if want < len(ranks):
            # A virtual sub-mesh: take a prefix of the ranks.
            ranks, domains = ranks[:want], domains[:want]
        if _mesh.dcn_present(domains):
            self.grid = self._hybrid(sizes, ranks, domains, _mesh)
        else:
            self.grid = _mesh.make_mesh(sizes, ranks)
        self.axes: Dict[str, int] = dict(self.grid.shape)

    @staticmethod
    def _resolve_wildcard(axes: Dict[str, int], n_devices: int
                          ) -> Dict[str, int]:
        wild = [name for name, s in axes.items() if s == -1]
        if len(wild) > 1:
            raise InvalidArgumentError("at most one axis may be -1")
        if wild:
            fixed = math.prod(s for s in axes.values() if s != -1)
            if fixed == 0 or n_devices % fixed != 0:
                raise InvalidArgumentError(
                    f"{n_devices} devices not divisible by {fixed}")
            axes[wild[0]] = n_devices // fixed
        return axes

    @staticmethod
    def _hybrid(sizes: Dict[str, int], ranks, domains, _mesh):
        """Split the axis stack at the host boundary: leading (major)
        axes multiply out to the host count and go across hosts; the rest
        tile one host's ranks."""
        n_domains, per = _mesh.slice_topology(domains)
        dcn_axes: Dict[str, int] = {}
        acc = 1
        names = list(sizes)
        i = 0
        while i < len(names) and acc < n_domains:
            name = names[i]
            dcn_axes[name] = sizes[name]
            acc *= sizes[name]
            i += 1
        ici_axes = {name: sizes[name] for name in names[i:]}
        if acc != n_domains:
            raise InvalidArgumentError(
                f"mesh axes {sizes} do not factor at the slice boundary "
                f"of {n_domains} domain(s) x {per} chip(s): leading axes "
                f"multiply to {acc}, need {n_domains}")
        return _mesh.hybrid_mesh(ici_axes=ici_axes or None,
                                 dcn_axes=dcn_axes or None,
                                 domains=domains, ranks=ranks)

    @classmethod
    def from_config(cls, config: str, *,
                    rules: Sequence[Tuple[str, Optional[str]]]
                    = DEFAULT_RULES, ranks=None,
                    domains=None) -> "LogicalMesh":
        """Build from the canonical config string (``"dp=8,tp=4"``)."""
        return cls(parse_mesh_config(config), rules=rules, ranks=ranks,
                   domains=domains)

    @property
    def ranks(self):
        """The rank grid: an integer array of the mesh's shape."""
        return self.grid.devices

    @property
    def mesh(self):
        """The ``torch.distributed`` ``DeviceMesh`` over the rank grid,
        built on first use (a collective: every rank asks in the same
        order)."""
        return self.grid.device_mesh

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.grid.axis_names)

    @property
    def config(self) -> str:
        """The canonical config string of this mesh's axis stack."""
        return format_mesh_config(self.axes)

    def defines(self, axis: str) -> bool:
        """True when ``axis`` is a physical axis of this mesh."""
        return axis in self.axes

    def axis(self, logical: str) -> Optional[str]:
        """Physical axis for one logical axis name, by the first rule
        whose physical axis this mesh defines; ``None`` = replicated.
        Unknown logical names raise."""
        known = False
        for name, phys in self.rules:
            if name != logical:
                continue
            known = True
            if phys is None:
                return None
            if phys in self.axes:
                return phys
        if not known:
            raise InvalidArgumentError(
                f"unknown logical axis {logical!r}: not in the rules "
                f"table (known: {sorted({n for n, _ in self.rules})})")
        return None

    def spec(self, *logical_axes: Optional[str]) -> Tuple[Optional[str], ...]:
        """Resolve logical tensor-dimension names to physical axes, one
        entry per dimension: ``spec("batch", None, "heads")`` ->
        ``("dp", None, "tp")`` on a dp x tp stack (the JAX package's
        ``PartitionSpec`` entries)."""
        resolved = [None if name is None else self.axis(name)
                    for name in logical_axes]
        used = [a for a in resolved if a is not None]
        dupes = {a for a in used if used.count(a) > 1}
        if dupes:
            raise InvalidArgumentError(
                f"logical axes {logical_axes} map {sorted(dupes)} onto "
                "more than one tensor dimension")
        return tuple(resolved)

    def role_axis(self, role: str) -> Optional[str]:
        """Physical axis for a parallelism role ('data', 'tensor', 'seq',
        'stage', 'expert'): the conventional spelling when the mesh
        defines it, else the first rules-mapped logical axis of the role,
        else the flat axis for 'data', else ``None``."""
        if role not in _ROLE_LOGICAL:
            raise InvalidArgumentError(
                f"unknown parallelism role {role!r} "
                f"(known: {sorted(_ROLE_LOGICAL)})")
        conventional = ROLE_AXES[role]
        if conventional in self.axes:
            return conventional
        for logical in _ROLE_LOGICAL[role]:
            phys = self.axis(logical)
            if phys is not None:
                return phys
        if role == "data" and DATA_AXIS in self.axes:
            return DATA_AXIS
        return None


_BOUND: List[LogicalMesh] = []


def bind(lm: LogicalMesh):
    """Context manager binding ``lm`` as the current logical mesh: the
    parallelism modules resolve their default axes against it
    (:func:`module_axis`)."""
    @contextlib.contextmanager
    def _ctx():
        _BOUND.append(lm)
        try:
            yield lm
        finally:
            _BOUND.pop()
    return _ctx()


def current_logical_mesh() -> Optional[LogicalMesh]:
    """The innermost :func:`bind`-ed mesh, or ``None``."""
    return _BOUND[-1] if _BOUND else None


def module_axis(role: str, override: Optional[str] = None) -> str:
    """A parallelism module's collective axis: an explicit ``axis=``
    wins, else the bound mesh's role resolution, else the per-module
    spelling. Raises when a bound mesh defines no axis for the role."""
    if override is not None:
        return override
    lm = current_logical_mesh()
    if lm is not None:
        axis = lm.role_axis(role)
        if axis is None:
            raise InvalidArgumentError(
                f"bound LogicalMesh {lm.config!r} defines no axis for "
                f"role {role!r}; add the axis to the mesh or pass axis= "
                "explicitly")
        return axis
    return _LEGACY_ROLE_AXES[role]


def logical_partition_specs(tree_logical_axes,
                            lm: Optional[LogicalMesh] = None):
    """Map a tree (dicts, lists, tuples) of logical-axis tuples to specs
    via the given or bound mesh."""
    from torch.utils._pytree import tree_map

    lm = lm or current_logical_mesh()
    if lm is None:
        raise InvalidArgumentError(
            "logical_partition_specs needs a LogicalMesh (bind one or "
            "pass lm=)")
    return tree_map(lambda dims: lm.spec(*dims), tree_logical_axes,
                    is_leaf=lambda x: isinstance(x, tuple))
