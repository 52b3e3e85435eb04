"""The profile store: one place where fitted constants override the
preset catalog.

``configs.base.PRESET_CATALOG`` is the single source of the datasheet
constants (DeviceInfo + achievable overlap per preset).  This module
layers fitted :class:`CalibrationProfile` objects on top: ``resolve``
answers "what constants should price device X" — a registered fitted
profile if one exists, else the catalog's scalar constants expressed
as a degenerate profile.  Nothing else in the tree caches per-device
constants, so a fitted profile overrides in exactly one place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.calibrate.profile import CalibrationProfile, default_profile
from repro_torch.configs import DeviceInfo

_REGISTRY: Dict[str, CalibrationProfile] = {}


def register(profile: CalibrationProfile) -> None:
    """Install a fitted profile for ``profile.device`` (overrides the
    catalog default until :func:`clear`)."""
    _REGISTRY[profile.device] = profile


def registered(name: str) -> Optional[CalibrationProfile]:
    """The fitted profile for ``name``, or None if none installed."""
    return _REGISTRY.get(name)


def registered_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def clear() -> None:
    """Drop all registered profiles (tests)."""
    _REGISTRY.clear()


def catalog_default(name: str) -> CalibrationProfile:
    """The preset catalog's scalar constants for ``name`` as a
    degenerate profile (constant efficiency curve, 1.30 remat, no
    fitted links).  Raises KeyError for unknown presets, matching
    ``DeviceInfo.preset``."""
    return default_profile(DeviceInfo.preset(name))


def resolve(name: str) -> CalibrationProfile:
    """The constants that should price device ``name``: the fitted
    profile if registered, else the catalog default."""
    got = _REGISTRY.get(name)
    return got if got is not None else catalog_default(name)


def load_and_register(path) -> CalibrationProfile:
    """Load a profile JSON (as written by `python -m repro_torch
    calibrate --out`) and install it."""
    profile = CalibrationProfile.load(path)
    register(profile)
    return profile
