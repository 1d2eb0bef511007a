"""Validation rules of extensions, from their params or function comments
(a copy of ``fugue_tpu/extensions/validation.py``): ``input_has``,
``input_is``, ``partitionby_has``, ``partitionby_is``, ``presort_has``,
``presort_is``."""

from typing import Any, Dict, List

from fugue_tpu_torch.collections.partition import PartitionSpec, parse_presort_exp
from fugue_tpu_torch.exceptions import (
    FugueWorkflowCompileError,
    FugueWorkflowCompileValidationError,
    FugueWorkflowRuntimeValidationError,
)
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.utils.assertion import assert_or_throw


class InvalidValidationRuleError(FugueWorkflowCompileError, ValueError):
    """An unknown rule key."""


class CompileValidationError(FugueWorkflowCompileValidationError, ValueError):
    """A partition spec fails an extension's rules."""


class RuntimeValidationError(FugueWorkflowRuntimeValidationError, ValueError):
    """An input schema fails an extension's rules."""


_VALID_KEYS = {"input_has", "input_is", "partitionby_has", "partitionby_is", "presort_has",
               "presort_is"}


def parse_validation_rules_from_comment(func: Any) -> Dict[str, Any]:
    from fugue_tpu_torch.extensions.schema_hint import parse_comment_annotations

    return {k: v for k, v in parse_comment_annotations(func).items() if k in _VALID_KEYS}


def _to_list(v: Any) -> List[str]:
    if isinstance(v, str):
        return [x.strip() for x in v.split(",") if x.strip() != ""]
    return list(v)


def validate_rules(rules: Dict[str, Any]) -> Dict[str, Any]:
    for k in rules:
        assert_or_throw(k in _VALID_KEYS, InvalidValidationRuleError(f"invalid validation rule {k}"))
    return rules


def validate_partition_spec(rules: Dict[str, Any], spec: PartitionSpec) -> None:
    if "partitionby_has" in rules:
        req = _to_list(rules["partitionby_has"])
        assert_or_throw(all(k in spec.partition_by for k in req), CompileValidationError(
            f"partitionby_has: {req} required but got {spec.partition_by}"))
    if "partitionby_is" in rules:
        req = _to_list(rules["partitionby_is"])
        assert_or_throw(req == spec.partition_by, CompileValidationError(
            f"partitionby_is: expected {req} got {spec.partition_by}"))
    if "presort_has" in rules:
        req = parse_presort_exp(rules["presort_has"])
        assert_or_throw(
            all(k in spec.presort and spec.presort[k] == v for k, v in req.items()),
            CompileValidationError(f"presort_has: {req} required but got {spec.presort}"))
    if "presort_is" in rules:
        req = parse_presort_exp(rules["presort_is"])
        assert_or_throw(req == spec.presort, CompileValidationError(
            f"presort_is: expected {req} got {spec.presort}"))


def validate_input_schema(rules: Dict[str, Any], schema: Schema) -> None:
    if "input_has" in rules:
        missing = [c for c in _to_list(rules["input_has"]) if c not in schema]
        assert_or_throw(len(missing) == 0, RuntimeValidationError(
            f"input_has: missing columns {missing} in {schema}"))
    if "input_is" in rules:
        assert_or_throw(schema == Schema(rules["input_is"]), RuntimeValidationError(
            f"input_is: expected {rules['input_is']} got {schema}"))
