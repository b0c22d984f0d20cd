"""Actor/learner device groups for the async engine (L5) of the port.

Counterpart of ``parse_group_spec``, ``DeviceGroups``, ``split_devices``
and ``split_mesh`` in the JAX package's ``parallel/groups.py``: carve the
visible devices into an ACTOR group (rollout collection) and a LEARNER
group (the minibatch update), with the same choices and refusals. The
groups hold ``torch.device``s; a device's id is its index (0 for the
CPU). JAX gives each group a 1-axis data mesh; the port has no meshes,
so:

- a SHARED group on one device runs both roles there, each on its own
  CUDA stream (one H100; the CPU in the tests);
- one actor device against one learner device runs the rollout on the
  first and the update on the second, the batch and the params hopping
  with ``.to(device, non_blocking=True)``. Nothing verifies this on a
  one-card machine: it is unverified, as the data-parallel slice's
  multi-rank paths are, so ``train --async`` takes it only when
  ``--actor-devices``/``--learner-devices`` ask for it (its default is
  the shared group on its ``--device``);
- a group of more than one device shards a phase over devices, which
  is data parallelism: :meth:`DeviceGroups.check_runnable` refuses it,
  naming the data-parallel slice, and so does :func:`split_mesh` (the
  unified mesh is that slice's too).
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device

_DP_SLICE = "the data-parallel slice (ROADMAP.md queue 1, item 21)"


def parse_group_spec(spec: str | int | None):
    """Parse a CLI device-group spec: an int (or digit string) is a
    device COUNT; a comma-separated string ("0,2,3") is explicit device
    indices. Returns ``None`` (defaulted), an int count, or a list of
    indices."""
    if spec is None:
        return None
    if isinstance(spec, int):
        return spec
    s = spec.strip()
    if "," in s:
        try:
            return [int(p) for p in s.split(",") if p.strip() != ""]
        except ValueError:
            raise ValueError(f"bad device-group spec {spec!r}: comma form "
                             f"must be integer device indices") from None
    try:
        return int(s)
    except ValueError:
        raise ValueError(f"bad device-group spec {spec!r}: expected a "
                         f"count or comma-separated indices") from None


def device_id(d: torch.device) -> int:
    """A device's id in the groups' texts: its index (0 for the CPU)."""
    return d.index if d.index is not None else 0


def home_device(device: torch.device) -> torch.device:
    """``device`` with its index (``cuda`` is the current card)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class DeviceGroups:
    """The actor/learner split: each group's devices, and whether both
    roles share one device set."""
    actor: tuple
    learner: tuple
    shared: bool  # both roles on the same device set (one-card rigs)

    def describe(self) -> str:
        if self.shared:
            return (f"shared group: {len(self.actor)} device(s) "
                    f"{[device_id(d) for d in self.actor]}")
        return (f"actor {[device_id(d) for d in self.actor]} | "
                f"learner {[device_id(d) for d in self.learner]}")

    def check_runnable(self) -> None:
        """Raise ``NotImplementedError`` for a group of more than one
        device: sharding the rollout or the update over devices is data
        parallelism, which the port does not have yet."""
        for role, group in (("actor", self.actor), ("learner", self.learner)):
            if len(group) > 1:
                raise NotImplementedError(
                    f"a {role} group of {len(group)} devices "
                    f"({self.describe()}) shards a phase over devices, "
                    f"which is not in the PyTorch port yet: it waits for "
                    f"{_DP_SLICE}; pass one device a group "
                    f"(--actor-devices 1 --learner-devices 1) or share one")

    @property
    def actor_device(self) -> torch.device:
        return self.actor[0]

    @property
    def learner_device(self) -> torch.device:
        return self.learner[0]


def _resolve(spec, devices, taken_from_front: bool):
    """Turn a parsed spec into a concrete device list."""
    if isinstance(spec, int):
        if not 1 <= spec <= len(devices):
            raise ValueError(f"group count {spec} out of range for "
                             f"{len(devices)} visible devices")
        return devices[:spec] if taken_from_front else devices[-spec:]
    ids = {device_id(d): d for d in devices}
    out = []
    for i in spec:
        if i not in ids:
            raise ValueError(f"device index {i} not among visible device "
                             f"ids {sorted(ids)}")
        out.append(ids[i])
    if len(set(spec)) != len(spec):
        raise ValueError(f"duplicate device index in group spec {spec}")
    if not out:
        raise ValueError("empty device group")
    return out


def visible_devices(device: "torch.device | str | None" = None
                    ) -> "list[torch.device]":
    """The devices a split carves: every visible CUDA device for
    ``cuda`` (the default), the one device an index names, or ``[cpu]``
    when the caller passes the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def split_devices(actor: str | int | list | None = None,
                  learner: str | int | list | None = None,
                  devices=None) -> DeviceGroups:
    """Carve the devices into actor/learner groups.

    ``devices`` is a list of devices, or one device (``"cpu"``,
    ``"cuda"``, ``"cuda:1"``) expanded by :func:`visible_devices`;
    default: the visible CUDA devices. Defaults: one device -> both
    roles share it; otherwise the first half acts and the second half
    learns (ties round the extra device to the actor). Explicit specs
    (counts or index lists, see :func:`parse_group_spec`) must be
    disjoint, EXCEPT when both name the identical set, which requests a
    shared group explicitly."""
    if devices is None or isinstance(devices, (str, torch.device)):
        devices = visible_devices(devices)
    devices = list(devices)
    n = len(devices)
    actor = parse_group_spec(actor) if isinstance(actor, (str, type(None))) \
        else actor
    learner = parse_group_spec(learner) \
        if isinstance(learner, (str, type(None))) else learner

    if actor is None and learner is None:
        if n == 1:
            a = l = devices
        else:
            a, l = devices[:(n + 1) // 2], devices[(n + 1) // 2:]
    elif actor is None:
        l = _resolve(learner, devices, taken_from_front=False)
        a = [d for d in devices if d not in l] or l
    elif learner is None:
        a = _resolve(actor, devices, taken_from_front=True)
        l = [d for d in devices if d not in a] or a
    else:
        a = _resolve(actor, devices, taken_from_front=True)
        l = _resolve(learner, devices, taken_from_front=False)

    shared = set(a) == set(l)
    if not shared and set(a) & set(l):
        raise ValueError(
            f"actor and learner groups overlap "
            f"({[device_id(d) for d in a]} vs "
            f"{[device_id(d) for d in l]}): groups must be disjoint, or "
            f"identical to request an explicitly shared group")
    return DeviceGroups(actor=tuple(a), learner=tuple(l), shared=shared)


def split_mesh(mesh, actor: str | int | list | None = None,
               learner: str | int | list | None = None) -> DeviceGroups:
    """JAX carves the groups out of the unified mesh; the port has no
    mesh, so this raises ``NotImplementedError``."""
    raise NotImplementedError(
        f"split_mesh carves the async groups out of the unified "
        f"Mesh(pop x data x model), which is not in the PyTorch port yet: "
        f"it waits for {_DP_SLICE}; use split_devices")
