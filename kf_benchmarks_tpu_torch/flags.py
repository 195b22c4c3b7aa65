"""Declarative parameter registry, decoupled from any flag parser.

The port's counterpart of kf_benchmarks_tpu/flags.py: ``DEFINE_*`` record a
``ParamSpec`` per parameter, ``params.make_params(**overrides)`` builds a
validated Params object for library use, and ``add_to_parser`` materialises
the registry as ``argparse`` options for the CLI (the port does not depend
on absl).
"""

from __future__ import annotations

import argparse
from collections import OrderedDict
from typing import Any, Optional


class ParamSpec:
  """One benchmark parameter: type, default, help and constraints
  (enum_values, lower_bound, upper_bound)."""

  __slots__ = ("name", "flag_type", "default_value", "description", "kwargs")

  def __init__(self, name: str, flag_type: str, default_value: Any,
               description: str, kwargs: Optional[dict] = None):
    self.name = name
    self.flag_type = flag_type
    self.default_value = default_value
    self.description = description
    self.kwargs = dict(kwargs or {})

  def __repr__(self):
    return (f"ParamSpec({self.name!r}, {self.flag_type!r}, "
            f"{self.default_value!r})")


param_specs: "OrderedDict[str, ParamSpec]" = OrderedDict()


def _define(name: str, flag_type: str, default_value: Any, description: str,
            **kwargs) -> None:
  if name in param_specs:
    raise ValueError(f"Duplicate param definition: {name}")
  param_specs[name] = ParamSpec(name, flag_type, default_value, description,
                                kwargs)


def DEFINE_string(name, default, help):  # noqa: N802
  _define(name, "string", default, help)


def DEFINE_boolean(name, default, help):  # noqa: N802
  _define(name, "boolean", default, help)


def DEFINE_integer(name, default, help, lower_bound=None,  # noqa: N802
                   upper_bound=None):
  _define(name, "integer", default, help, lower_bound=lower_bound,
          upper_bound=upper_bound)


def DEFINE_float(name, default, help, lower_bound=None):  # noqa: N802
  _define(name, "float", default, help, lower_bound=lower_bound)


def DEFINE_enum(name, default, enum_values, help):  # noqa: N802
  _define(name, "enum", default, help, enum_values=list(enum_values))


def DEFINE_list(name, default, help):  # noqa: N802
  """A comma-separated list of strings."""
  _define(name, "list", list(default or []), help)


def canonicalize_value(spec: ParamSpec, value: Any) -> Any:
  """Coerce a raw (possibly string) value to the spec's python type."""
  if value is None:
    return None
  t = spec.flag_type
  if t in ("string", "enum"):
    return str(value)
  if t == "list":
    if isinstance(value, str):
      return [v for v in value.split(",") if v]
    return list(value)
  if t == "boolean":
    if isinstance(value, bool):
      return value
    if isinstance(value, str):
      low = value.lower()
      if low in ("true", "1", "yes"):
        return True
      if low in ("false", "0", "no"):
        return False
      raise ValueError(f"--{spec.name}: invalid boolean {value!r}")
    return bool(value)
  if t == "integer":
    return int(value)
  if t == "float":
    return float(value)
  raise ValueError(f"Unknown flag type {t!r} for {spec.name}")


def check_value(spec: ParamSpec, value: Any) -> None:
  """Validate one value against its spec's enum and bounds."""
  if value is None:
    return
  if spec.flag_type == "enum":
    enum_values = spec.kwargs["enum_values"]
    if value not in enum_values:
      raise ValueError(
          f"The value {value!r} of parameter {spec.name} must be one of "
          f"{enum_values}")
  lo = spec.kwargs.get("lower_bound")
  if lo is not None and value < lo:
    raise ValueError(f"Param {spec.name}={value} is below lower bound {lo}")
  hi = spec.kwargs.get("upper_bound")
  if hi is not None and value > hi:
    raise ValueError(f"Param {spec.name}={value} is above upper bound {hi}")


def add_to_parser(parser: argparse.ArgumentParser) -> None:
  """One ``--name=value`` option per registered parameter; a boolean also
  takes the bare ``--name``."""
  for name, spec in param_specs.items():
    nargs = {"nargs": "?", "const": "true"} if spec.flag_type == "boolean" \
        else {}
    parser.add_argument(f"--{name}", default=None, help=spec.description,
                        **nargs)
