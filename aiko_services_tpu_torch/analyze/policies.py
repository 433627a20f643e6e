# Pass 4 -- policy-grammar verification (AIKO4xx).
#
# Every operator-facing mini-grammar the engine grew -- the
# fault-tolerance parameters (`on_error`, `max_retries`, ...), the
# fault-injection spec (faults.py), and the gateway admission policy
# (serve/policy.py) -- now parses through ONE shared core
# (analyze/grammar.py), so this pass can verify any of them OFFLINE
# with the same error quality construction would produce: a typo'd
# policy is a lint finding in CI, not a wedged stream at 2 a.m.

from __future__ import annotations

from .diagnostics import AnalysisReport, Diagnostic
from .grammar import Field, GrammarError, split_directives

__all__ = ["run_policy_pass", "check_gateway_policy",
           "check_autopilot_policy", "check_autoscale_policy",
           "check_checkpoint_policy", "check_disagg_policy",
           "check_faults_spec", "check_federation_policy",
           "check_journal_policy", "check_decode_parameters",
           "check_prefix_policy", "check_tune_spec",
           "parse_speculative_spec", "FAULT_TOLERANCE_FIELDS",
           "DECODE_FIELDS", "DISAGG_FIELDS", "SPECULATIVE_FIELDS"]

# The PR-3 fault-tolerance parameter vocabulary (pipeline / element /
# stream scoped).  `on_error` choices are filled in lazily from the
# engine's ERROR_POLICIES so the two can never drift.
FAULT_TOLERANCE_FIELDS = {
    "max_retries": Field("int", minimum=0),
    "retry_backoff_ms": Field("float", minimum=0.0),
    "error_budget": Field("int", minimum=0),
    "error_window": Field("float", minimum=0.0),
    "frame_deadline": Field("float", minimum=0.0),
    "park_timeout": Field("float", minimum=0.0),
}


# The continuous-batching engine parameters (decode/, LMGenerate
# `continuous: true`).  kv_blocks >= 2 because block 0 is the reserved
# trash block (decode/blocks.py) -- a 1-block pool has zero allocatable
# capacity.
DECODE_FIELDS = {
    "continuous": Field("flag"),
    "decode_slots": Field("int", minimum=1),
    "kv_block_size": Field("int", minimum=1),
    "kv_blocks": Field("int", minimum=2),
    "max_context": Field("int", minimum=1),
    "eos_id": Field("int", minimum=0),
    "prefill_chunk_size": Field("int", minimum=1),
    "speculative": Field("str"),
}

# Element-level disaggregation parameters (LMGenerate `role` /
# `adopt_timeout`): checked as AIKO408 -- the same rule family as the
# gateway's `disagg` policy spec, because both describe the SAME
# prefill/decode split and must fail the same way offline and at
# construction.
DISAGG_FIELDS = {
    "role": Field("str", choices=("prefill", "decode")),
    "adopt_timeout": Field("float", minimum=0.0),
}


# The `speculative` directive (LMGenerate parameter, `;`-separated
# key=value through the shared grammar core): greedy-exact speculative
# decoding on the continuous engine.  `draft` selects the proposal
# model -- an _LM_PRESETS name, or "self" for the target's own config
# family shrunk by the `layers`/`d_ff` overrides (random-init from
# `seed`; the production path loads a trained draft via a preset).
# `k` is the proposal run length per verify window.
SPECULATIVE_FIELDS = {
    "draft": Field("str"),
    "k": Field("int", minimum=1, maximum=16),
    "layers": Field("int", minimum=1),
    "d_ff": Field("int", minimum=1),
    "seed": Field("int", minimum=0),
}


def parse_speculative_spec(spec) -> dict:
    """`draft=<preset|self>;k=<n>[;layers=<n>][;d_ff=<n>][;seed=<n>]`
    -> coerced dict.  Raises GrammarError (a ValueError) with the same
    message offline lint reports as AIKO405."""
    parsed = {}
    for part in split_directives(spec):
        key, separator, value = part.partition("=")
        key = key.strip()
        if not separator or key not in SPECULATIVE_FIELDS:
            raise GrammarError(
                f"speculative: unknown entry {part!r}; expected "
                f"key=value with keys {sorted(SPECULATIVE_FIELDS)}",
                kind="unknown")
        parsed[key] = SPECULATIVE_FIELDS[key].coerce(
            "speculative", key, value.strip())
    for required in ("draft", "k"):
        if required not in parsed:
            raise GrammarError(
                f"speculative: missing required entry "
                f"{required}=<value>")
    if parsed["draft"] != "self" and (
            "layers" in parsed or "d_ff" in parsed):
        raise GrammarError(
            "speculative: layers=/d_ff= overrides only apply to "
            "draft=self (a preset draft has its own dims)")
    return parsed


def check_decode_parameters(parameters: dict,
                            disagg_scope: bool = True) -> list:
    """(code, message) problems in one element's continuous-batching
    parameter set: per-field type/bounds, plus the cross-field pool
    sanity check (a pool that cannot hold even one completion admits
    nothing -- every submit would raise, which should be a lint
    finding, not a serving-time surprise).  `disagg_scope=False` skips
    the AIKO408 role/adopt_timeout rules: `role` is a generic
    parameter name, and only elements that actually interpret it as a
    disagg pool (LMGenerate) may be judged by its vocabulary."""
    problems = []
    clean = {}
    for key, field in DECODE_FIELDS.items():
        if key not in parameters:
            continue
        try:
            clean[key] = field.coerce("decode", key, parameters[key])
        except ValueError as error:
            problems.append(("AIKO405", str(error)))
    if disagg_scope:
        for key, field in DISAGG_FIELDS.items():
            if key not in parameters:
                continue
            try:
                clean[key] = field.coerce("disagg", key,
                                          parameters[key])
            except ValueError as error:
                problems.append(("AIKO408", str(error)))
        if "checkpoint" in parameters:
            # the warm-KV-failover snapshot spec (decode/checkpoint.py)
            # is engine-scoped here: recovery_rate belongs on the
            # gateway's `checkpoint` / the `checkpoint_policy` parameter
            checkpoint_problems = check_checkpoint_policy(
                parameters["checkpoint"], element=True)
            problems.extend(checkpoint_problems)
            if not checkpoint_problems:
                clean["checkpoint"] = parameters["checkpoint"]
        if "prefix_policy" in parameters:
            # the cross-request prefix-reuse spec (decode/prefix.py) is
            # engine-scoped here: affinity_weight belongs on the
            # gateway's `prefix` / the definition-level `prefix_policy`
            prefix_problems = check_prefix_policy(
                parameters["prefix_policy"], element=True)
            problems.extend(prefix_problems)
            if not prefix_problems:
                clean["prefix_policy"] = parameters["prefix_policy"]
    if "speculative" in clean:
        try:
            parse_speculative_spec(clean["speculative"])
        except ValueError as error:
            problems.append(("AIKO405", str(error)))
    # both kernel-floor features ride the continuous engine: on the
    # closed-batch path they would be silently ignored, which is a
    # misconfiguration worth failing offline
    for feature in ("speculative", "prefill_chunk_size"):
        if feature in clean and not clean.get("continuous"):
            if clean.get("role") == "prefill" \
                    and feature == "prefill_chunk_size":
                continue  # the prefill engine chunks without decoding
            problems.append((
                "AIKO405",
                f"{feature} requires continuous=true (the closed-batch "
                f"path ignores it)"))
    # disagg cross-field rules: a decode-pool element IS the continuous
    # engine (adoption rewrites slot block tables); a prefill-pool
    # element never decodes, so the continuous/speculative knobs on it
    # are dead configuration worth failing offline
    role = clean.get("role")
    if role == "decode" and not clean.get("continuous"):
        problems.append((
            "AIKO408",
            "role=decode requires continuous=true (adoption needs the "
            "slot engine)"))
    if role == "prefill":
        for feature in ("continuous", "speculative"):
            if clean.get(feature):
                problems.append((
                    "AIKO408",
                    f"role=prefill does not decode; drop {feature}"))
    if "adopt_timeout" in clean and role != "decode":
        problems.append((
            "AIKO408",
            "adopt_timeout only applies to role=decode (the adopting "
            "side of the KV migration)"))
    if "checkpoint" in clean:
        if role == "prefill":
            problems.append((
                "AIKO409",
                "role=prefill holds no decode state to checkpoint; "
                "drop checkpoint"))
        elif not clean.get("continuous"):
            problems.append((
                "AIKO409",
                "checkpoint requires continuous=true (snapshots ride "
                "the slot engine)"))
    if "prefix_policy" in clean:
        if role == "prefill":
            problems.append((
                "AIKO411",
                "role=prefill exports its KV per handoff, not into a "
                "slot pool; drop prefix_policy"))
        elif not clean.get("continuous"):
            problems.append((
                "AIKO411",
                "prefix_policy requires continuous=true (the cache "
                "indexes the slot engine's paged pool)"))
    if problems or not clean.get("continuous"):
        return problems
    block_size = clean.get("kv_block_size", 16)
    kv_blocks = clean.get("kv_blocks")
    max_new = parameters.get("max_new_tokens")
    if kv_blocks is not None and max_new is not None:
        try:
            max_new = int(max_new)
        except (TypeError, ValueError):
            return problems  # max_new_tokens is not this pass's rule
        needed = -(-(max_new + 1) // block_size)
        if needed > kv_blocks - 1:
            problems.append((
                "AIKO405",
                f"kv_blocks={kv_blocks} gives {kv_blocks - 1} "
                f"allocatable blocks of {block_size}, but one "
                f"completion of max_new_tokens={max_new} needs "
                f"{needed}: no request could ever be admitted"))
    max_context = clean.get("max_context")
    if max_context is not None and max_new is not None:
        # mirror DecodeEngine.__init__: max_context is rounded UP to a
        # block multiple at runtime, so the lint must judge the rounded
        # capacity or it rejects configs the engine accepts
        effective = -(-max_context // block_size) * block_size
        try:
            if int(max_new) + 1 > effective:
                problems.append((
                    "AIKO405",
                    f"max_context={max_context} (rounded to "
                    f"{effective} = a kv_block_size={block_size} "
                    f"multiple) cannot hold a single completion of "
                    f"max_new_tokens={int(max_new)} plus a 1-token "
                    f"prompt"))
        except (TypeError, ValueError):
            pass
    return problems


def _on_error_field():
    from ..pipeline.element import ERROR_POLICIES
    return Field("str", choices=ERROR_POLICIES)


def check_faults_spec(spec) -> list:
    """(code, message) problems in a fault-injection spec."""
    from ..faults import FAULTS_GRAMMAR
    return FAULTS_GRAMMAR.check(spec, value_code="AIKO402")


def check_gateway_policy(spec) -> list:
    """(code, message) problems in a gateway admission-policy spec.

    After the per-directive grammar check, a grammar-clean spec goes
    through the REAL AdmissionPolicy.parse so cross-field constraints
    (throttle_low <= throttle_high, bucket rate/burst > 0) fail
    offline exactly as they would at Gateway construction."""
    from ..serve.policy import POLICY_GRAMMAR, AdmissionPolicy
    problems = POLICY_GRAMMAR.check(spec, value_code="AIKO403")
    if not problems:
        try:
            AdmissionPolicy.parse(spec)
        except ValueError as error:
            problems.append(("AIKO403", str(error)))
    return problems


def check_journal_policy(spec) -> list:
    """(code, message) problems in a gateway HA/journal spec.  Same
    shape as check_gateway_policy: the per-directive grammar check,
    then the REAL JournalPolicy.parse so the cross-field constraint
    (backend=sqlite requires path=) fails offline exactly as it would
    at Gateway construction."""
    from ..serve.journal import JOURNAL_GRAMMAR, JournalPolicy
    problems = JOURNAL_GRAMMAR.check(spec, value_code="AIKO407")
    if not problems:
        try:
            JournalPolicy.parse(spec)
        except ValueError as error:
            problems.append(("AIKO407", str(error)))
    return problems


def check_tune_spec(spec) -> list:
    """(code, message) problems in a `tune` SLO/directive spec (the
    operating point a definition pins for `aiko tune`): the shared
    grammar core validates it offline as AIKO501, exactly as
    SloSpec.parse would at tune time."""
    from ..tune.slo import check_tune_spec as check
    return check(spec)


def check_disagg_policy(spec) -> list:
    """(code, message) problems in a prefill/decode disaggregation
    spec (gateway `disagg` parameter, or a replica definition's
    `disagg: "role=..."`).  Same shape as check_gateway_policy: the
    per-directive grammar check as AIKO408, then the REAL
    DisaggPolicy.parse so cross-field constraints (role= is
    replica-side only) fail offline exactly as at construction."""
    from ..serve.disagg import DISAGG_GRAMMAR, DisaggPolicy
    problems = DISAGG_GRAMMAR.check(spec, value_code="AIKO408")
    if not problems:
        try:
            DisaggPolicy.parse(spec)
        except ValueError as error:
            problems.append(("AIKO408", str(error)))
    return problems


def check_checkpoint_policy(spec, element: bool = False) -> list:
    """(code, message) problems in a warm-KV-failover checkpoint spec
    (rule code AIKO409).  Same shape as check_disagg_policy: the
    per-directive grammar check, then the REAL CheckpointPolicy.parse
    plus its scope validation -- `recovery_rate` is gateway-side
    (failover pacing), `checkpoint_every`/`max_checkpoint_lag` are
    engine-side (snapshot cadence) -- so a spec on the wrong side
    fails offline exactly as at construction."""
    from ..decode.checkpoint import CHECKPOINT_GRAMMAR, CheckpointPolicy
    problems = CHECKPOINT_GRAMMAR.check(spec, value_code="AIKO409")
    if not problems:
        try:
            policy = CheckpointPolicy.parse(spec)
            if element:
                policy.validate_engine()
            else:
                policy.validate_gateway()
        except ValueError as error:
            problems.append(("AIKO409", str(error)))
    return problems


def check_autoscale_policy(spec) -> list:
    """(code, message) problems in an elastic-fleet autoscale spec.
    Same shape as check_gateway_policy: the per-directive grammar
    check, then the REAL ScalePolicy.parse so cross-field constraints
    (min <= max replicas, low_water < high_water) fail offline exactly
    as they would when the gateway enables the autoscaler."""
    from ..serve.autoscale import AUTOSCALE_GRAMMAR, ScalePolicy
    problems = AUTOSCALE_GRAMMAR.check(spec, value_code="AIKO406")
    if not problems:
        try:
            ScalePolicy.parse(spec)
        except ValueError as error:
            problems.append(("AIKO406", str(error)))
    return problems


def check_prefix_policy(spec, element: bool = False) -> list:
    """(code, message) problems in a cross-request prefix-reuse spec
    (rule code AIKO411): the per-directive grammar check, then the REAL
    PrefixPolicy.parse plus its scope validation -- `affinity_weight` is
    gateway-side (routing score), `min_prefix_blocks`/`cache_blocks` are
    engine-side (cache shape) -- so a spec on the wrong side fails
    offline exactly as at construction."""
    from ..decode.prefix import PREFIX_GRAMMAR, PrefixPolicy
    problems = PREFIX_GRAMMAR.check(spec, value_code="AIKO411")
    if not problems:
        try:
            policy = PrefixPolicy.parse(spec)
            if element:
                policy.validate_engine()
            else:
                policy.validate_gateway()
        except ValueError as error:
            problems.append(("AIKO411", str(error)))
    return problems


def check_autopilot_policy(spec) -> list:
    """(code, message) problems in an online SLO autopilot spec (rule
    code AIKO412).  Same shape as check_gateway_policy: the
    per-directive grammar check, then the REAL AutopilotPolicy.parse
    so cross-field constraints (burn_window > 0, max_delta_frac > 0)
    fail offline exactly as Gateway construction would."""
    from ..serve.autopilot import AUTOPILOT_GRAMMAR, AutopilotPolicy
    problems = AUTOPILOT_GRAMMAR.check(spec, value_code="AIKO412")
    if not problems:
        try:
            AutopilotPolicy.parse(spec)
        except ValueError as error:
            problems.append(("AIKO412", str(error)))
    return problems


def check_federation_policy(spec) -> list:
    """(code, message) problems in a federated-gateway spec.  Same
    shape as check_gateway_policy: the per-directive grammar check as
    AIKO410, then the REAL FederationPolicy.parse so cross-field
    constraints (non-empty unique groups, own group in the set) fail
    offline exactly as Gateway construction would."""
    from ..serve.federation import FEDERATION_GRAMMAR, FederationPolicy
    problems = FEDERATION_GRAMMAR.check(spec, value_code="AIKO410")
    if not problems:
        try:
            FederationPolicy.parse(spec)
        except ValueError as error:
            problems.append(("AIKO410", str(error)))
    return problems


def run_policy_pass(definition) -> AnalysisReport:
    report = AnalysisReport(passes_run=["policy"])
    name = definition.name
    on_error = _on_error_field()
    scopes = ([("", definition.parameters, None)]
              + [(element.name, element.parameters, element)
                 for element in definition.elements])
    for element_name, parameters, element in scopes:
        parameters = parameters or {}
        fields = dict(FAULT_TOLERANCE_FIELDS)
        fields["on_error"] = on_error
        for key, field in fields.items():
            if key not in parameters:
                continue
            try:
                field.coerce("fault-tolerance", key, parameters[key])
            except ValueError as error:
                report.add(Diagnostic(
                    "AIKO401", str(error), definition=name,
                    element=element_name))
        # `role`/`adopt_timeout` are only disagg vocabulary on elements
        # that interpret them (LMGenerate); a Detector with
        # role="primary" must not trip AIKO408
        disagg_scope = (
            element is not None
            and (element.deploy_local or {}).get("class_name")
            == "LMGenerate")
        triggers = (tuple(DECODE_FIELDS)
                    + ((tuple(DISAGG_FIELDS)
                        + ("checkpoint", "prefix_policy"))
                       if disagg_scope else ()))
        if any(key in parameters for key in triggers):
            for code, message in check_decode_parameters(
                    parameters, disagg_scope=disagg_scope):
                report.add(Diagnostic(code, message, definition=name,
                                      element=element_name))
            if (disagg_scope and parameters.get("checkpoint")
                    and element is not None
                    and not any(
                        str(port.get("name")) == "restore"
                        for port in (element.input or []))):
                # without the optional `restore` input port the
                # gateway's failover hint is dropped by map_in: the
                # element pays the snapshot tax every tick but every
                # failover silently re-prefills cold
                report.add(Diagnostic(
                    "AIKO409",
                    "checkpoint is set but the element declares no "
                    "`restore` input port (add {\"name\": \"restore\", "
                    "\"optional\": true}): failover hints would be "
                    "dropped and every recovery re-prefills cold",
                    definition=name, element=element_name))
    faults_spec = (definition.parameters or {}).get("faults")
    if faults_spec:
        for code, message in check_faults_spec(faults_spec):
            report.add(Diagnostic(code, message, definition=name))
    # gateways are services, not graph nodes, but operators embed their
    # policy next to the definition often enough to be worth checking
    policy_spec = (definition.parameters or {}).get("gateway_policy")
    if policy_spec:
        for code, message in check_gateway_policy(policy_spec):
            report.add(Diagnostic(code, message, definition=name))
    autoscale_spec = (definition.parameters or {}).get("autoscale_policy")
    if autoscale_spec:
        for code, message in check_autoscale_policy(autoscale_spec):
            report.add(Diagnostic(code, message, definition=name))
    # `disagg` pins a REPLICA's pool role; `disagg_policy` is a
    # gateway-side spec embedded next to the definition (both AIKO408)
    for parameter in ("disagg", "disagg_policy"):
        disagg_spec = (definition.parameters or {}).get(parameter)
        if disagg_spec:
            for code, message in check_disagg_policy(disagg_spec):
                report.add(Diagnostic(code, message, definition=name))
    # `checkpoint_policy` is the gateway-side warm-failover spec
    # embedded next to the definition (element-level `checkpoint` specs
    # are checked engine-scoped through check_decode_parameters above)
    checkpoint_spec = (definition.parameters or {}).get(
        "checkpoint_policy")
    if checkpoint_spec:
        for code, message in check_checkpoint_policy(checkpoint_spec):
            report.add(Diagnostic(code, message, definition=name))
    journal_spec = (definition.parameters or {}).get("journal_policy")
    if journal_spec:
        for code, message in check_journal_policy(journal_spec):
            report.add(Diagnostic(code, message, definition=name))
    # `autopilot_policy` is the gateway-side online-tuning loop spec
    # embedded next to the definition (serve/autopilot.py)
    autopilot_spec = (definition.parameters or {}).get(
        "autopilot_policy")
    if autopilot_spec:
        for code, message in check_autopilot_policy(autopilot_spec):
            report.add(Diagnostic(code, message, definition=name))
    # `federation_policy` is the gateway-side federated-tier spec
    # embedded next to the definition (stream -> group consistent hash)
    federation_spec = (definition.parameters or {}).get(
        "federation_policy")
    if federation_spec:
        for code, message in check_federation_policy(federation_spec):
            report.add(Diagnostic(code, message, definition=name))
    # DEFINITION-level `prefix_policy` is the gateway-side affinity
    # spec embedded next to the definition; element-level
    # `prefix_policy` specs were checked engine-scoped through
    # check_decode_parameters above (same split as checkpoint)
    prefix_spec = (definition.parameters or {}).get("prefix_policy")
    if prefix_spec:
        for code, message in check_prefix_policy(prefix_spec):
            report.add(Diagnostic(code, message, definition=name))
    tune_spec = (definition.parameters or {}).get("tune")
    if tune_spec:
        for code, message in check_tune_spec(tune_spec):
            report.add(Diagnostic(code, message, definition=name))
    return report
