# Federated gateway tier: multiple HA gateway groups sharing one
# replica fleet, with streams assigned to groups by CONSISTENT HASH of
# the stream id.
#
# Why: one gateway actor is a single event loop -- at O(10k) concurrent
# streams its mailbox becomes the serving tier's ceiling.  Federation
# splits the stream space across G independent gateway groups (each
# optionally an HA pair via the existing `ha=<group>` RetainedElection,
# serve/gateway.py) that all front the SAME replica pool.  Because the
# assignment is a pure function of (stream id, group set), every
# client, every gateway, and every test computes the same placement
# with no coordination, and a group's crash-failover composes
# unchanged: journals are already namespaced per group
# ("{ns}/gateway/{group}/journal"), so the group's standby adopts
# exactly its own streams.
#
# Assignment is rendezvous (highest-random-weight) hashing over a
# stable digest -- adding or removing one group moves only ~1/G of the
# streams, and the hash is identical across processes and Python runs
# (hashlib, never the salted builtin hash()).
#
# Regions: real fleets have geography.  A group entry may carry a
# region label (`us:a` = group "a" in region "us"; unlabeled entries
# live in the anonymous region "").  Placement is then region-aware in
# two layers: a client-declared region affinity narrows the rendezvous
# domain to that region's groups when any survive, and the rendezvous
# hash is the fallback -- so losing one region's groups remaps ONLY the
# streams that lived there (the rendezvous property), and every other
# stream keeps its pin.
#
# Grammar (gateway parameter `federation`, the shared directive style):
#
#   policy    := directive (";" directive)*
#   directive := "groups=" entry ("," entry)*  the full group set (the
#                                              hash domain; identical
#                                              on every member)
#              | "group=" entry                THIS gateway's own group
#                                              (defaults to its ha
#                                              group, else its name)
#   entry     := [region ":"] name             region label optional,
#                                              "" region when absent
#
# Examples: "groups=g0,g1,g2,g3;group=g1"
#           "groups=us:a,us:b,eu:c;group=eu:c"
#
# A federated gateway REJECTS streams that hash to another group with
# the typed shed reason "wrong_group" -- a misconfigured client fails
# fast instead of splitting a stream's frames across groups.
# Validation is at parse time through the shared directive core
# (analyze/grammar.py): `aiko lint` checks it offline as AIKO410 with
# the same messages Gateway construction raises.

# The port's own copy of aiko_services_tpu/serve/federation.py (host
# only, jax-free there too): the same grammar, hash and router.
#

from __future__ import annotations

import hashlib

from ..analyze.grammar import DirectiveGrammar, Field, GrammarError

__all__ = ["FEDERATION_GRAMMAR", "FederationPolicy", "FederationRouter",
           "assign_group"]

FEDERATION_GRAMMAR = DirectiveGrammar(
    "federation policy",
    options={
        "groups": Field("str"),
        "group": Field("str"),
    })


def assign_group(stream_id, groups) -> str:
    """The federated tier's ONE placement rule: rendezvous hashing of
    `stream_id` over `groups`.  Pure and process-stable (md5, not the
    salted builtin hash), so clients and gateways agree with no
    coordination; ties break to the lexicographically first group."""
    stream_id = str(stream_id)
    best = None
    best_score = -1
    for group in sorted(groups):
        digest = hashlib.md5(
            f"{group}\x00{stream_id}".encode("utf-8")).digest()
        score = int.from_bytes(digest[:8], "big")
        if score > best_score:
            best, best_score = group, score
    if best is None:
        raise ValueError("assign_group needs a non-empty group set")
    return best


def split_region(entry: str) -> tuple[str, str]:
    """`us:a` -> ("us", "a"); an unlabeled `a` -> ("", "a")."""
    entry = str(entry).strip()
    if ":" in entry:
        region, _, name = entry.partition(":")
        return region.strip(), name.strip()
    return "", entry


class FederationPolicy:
    """Parsed federation spec: the full group set (with optional
    per-group region labels) plus this gateway's own group (None =
    derive from ha group / gateway name)."""

    __slots__ = ("groups", "group", "regions", "spec")

    def __init__(self):
        self.groups: tuple[str, ...] = ()
        self.group: str | None = None
        self.regions: dict[str, str] = {}
        self.spec = ""

    @classmethod
    def parse(cls, spec) -> "FederationPolicy":
        policy = cls()
        if spec is None or spec == "":
            return policy
        if isinstance(spec, FederationPolicy):
            return spec
        parsed = FEDERATION_GRAMMAR.parse(spec)
        if not isinstance(spec, dict):
            policy.spec = str(spec)
        raw = parsed.options.get("groups", "")
        if isinstance(raw, (list, tuple)):
            entries = [str(entry).strip() for entry in raw]
        else:
            entries = [entry.strip() for entry in str(raw).split(",")]
        entries = [entry for entry in entries if entry]
        if not entries:
            raise GrammarError(
                "federation policy: groups= needs at least one group "
                "name (e.g. groups=g0,g1 or groups=us:a,eu:b)")
        names = []
        regions: dict[str, str] = {}
        for entry in entries:
            region, name = split_region(entry)
            if not name:
                raise GrammarError(
                    f"federation policy: empty group name in "
                    f"groups entry {entry!r}")
            names.append(name)
            regions[name] = region
        if len(set(names)) != len(names):
            raise GrammarError(
                f"federation policy: duplicate group names in "
                f"groups={','.join(names)}")
        policy.groups = tuple(names)
        policy.regions = regions
        own = parsed.options.get("group")
        if own is not None:
            own_region, own = split_region(own)
            if own not in policy.groups:
                raise GrammarError(
                    f"federation policy: group={own!r} is not in "
                    f"groups={','.join(policy.groups)}")
            if own_region and regions.get(own, "") != own_region:
                raise GrammarError(
                    f"federation policy: group={own_region}:{own} "
                    f"disagrees with groups= (region "
                    f"{regions.get(own, '')!r} there)")
            policy.group = own
        return policy

    def region_of(self, group: str) -> str:
        return self.regions.get(group, "")

    def region_groups(self, region: str) -> tuple[str, ...]:
        """Every group living in `region` (hash-domain order)."""
        return tuple(group for group in self.groups
                     if self.regions.get(group, "") == region)

    def owner_of(self, stream_id, region=None, lost=()) -> str:
        """Region-aware placement: the client's declared region
        affinity narrows the rendezvous domain to that region's
        surviving groups when any exist; otherwise rendezvous over all
        survivors.  `lost` excludes dead groups, so a region outage
        remaps only that region's streams onto the survivors while
        every other stream keeps its original owner."""
        survivors = [group for group in self.groups if group not in lost]
        if not survivors:
            raise ValueError(
                "federation policy: every group is lost -- no owner "
                f"for stream {stream_id!r}")
        if region is not None:
            local = [group for group in survivors
                     if self.regions.get(group, "") == str(region)]
            if local:
                return assign_group(stream_id, local)
        return assign_group(stream_id, survivors)

    def __repr__(self):
        labeled = [(f"{self.regions[group]}:{group}"
                    if self.regions.get(group) else group)
                   for group in self.groups]
        return (f"FederationPolicy(groups={labeled}, "
                f"group={self.group})")


class FederationRouter:
    """Client-side stream placement over a federated tier: holds one
    gateway handle (or submit surface) per group and forwards each
    stream's calls to the group its id hashes to -- the same
    region-aware owner_of the gateways enforce, so a routed stream is
    never shed wrong_group.  Handles are anything with submit_stream /
    submit_frame / destroy-by-post (the Gateway local surface); tests
    and the bench use in-process Gateway objects directly.

    With a `policy` (or a `regions` map) the router is region-aware:
    `submit_stream(..., region="us")` records the affinity and injects
    it into the stream parameters so the owning gateway audits the
    same placement; `fail_group` / `heal_group` mark groups lost so
    subsequent placement (and the re-submission of adopted streams)
    lands on the survivors -- and each surviving in-process gateway is
    told via `note_group_lost` so it warms the lost group's journal
    mirror and adopts its share of the streams."""

    def __init__(self, gateways: dict, policy=None, regions=None):
        if not gateways:
            raise ValueError("FederationRouter needs at least one group")
        self.gateways = dict(gateways)
        self.groups = tuple(sorted(self.gateways))
        if policy is not None and not isinstance(policy, FederationPolicy):
            policy = FederationPolicy.parse(policy)
        if policy is None:
            policy = FederationPolicy()
            policy.groups = self.groups
            policy.regions = {group: "" for group in self.groups}
        if regions:
            policy.regions = dict(policy.regions)
            policy.regions.update(
                {str(group): str(region)
                 for group, region in dict(regions).items()})
        self.policy = policy
        self._lost: set[str] = set()
        self._stream_regions: dict[str, str] = {}

    @property
    def lost_groups(self) -> frozenset:
        return frozenset(self._lost)

    def fail_group(self, group: str) -> None:
        """Mark `group` dead for placement and tell every surviving
        in-process gateway so it adopts its rendezvous share of the
        lost group's journaled streams (warm-KV restore hints ride the
        migration, decode/checkpoint.py)."""
        group = str(group)
        if group not in self.gateways:
            raise ValueError(f"fail_group: unknown group {group!r}")
        if group in self._lost:
            return
        self._lost.add(group)
        for name, gateway in self.gateways.items():
            if name in self._lost:
                continue
            post = getattr(gateway, "post_message", None)
            if post is not None:
                post("note_group_lost", [group])

    def heal_group(self, group: str) -> None:
        group = str(group)
        if group not in self._lost:
            return
        self._lost.discard(group)
        for name, gateway in self.gateways.items():
            if name == group or name in self._lost:
                continue
            post = getattr(gateway, "post_message", None)
            if post is not None:
                post("note_group_healed", [group])

    def group_for(self, stream_id, region=None) -> str:
        if region is None:
            region = self._stream_regions.get(str(stream_id))
        return self.policy.owner_of(stream_id, region=region,
                                    lost=self._lost)

    def gateway_for(self, stream_id):
        return self.gateways[self.group_for(stream_id)]

    def submit_stream(self, stream_id, region=None, **kwargs) -> str:
        """Create the stream on its owner group (region affinity
        first, rendezvous fallback); returns the group name (callers
        correlate responses per group)."""
        stream_id = str(stream_id)
        if region is not None:
            self._stream_regions[stream_id] = str(region)
            parameters = dict(kwargs.get("parameters") or {})
            parameters.setdefault("region", str(region))
            kwargs["parameters"] = parameters
        group = self.group_for(stream_id, region=region)
        self.gateways[group].submit_stream(stream_id, **kwargs)
        return group

    def submit_frame(self, stream_id, frame_data, frame_id=None) -> None:
        self.gateway_for(stream_id).submit_frame(
            stream_id, frame_data, frame_id=frame_id)

    def destroy_stream(self, stream_id) -> None:
        stream_id = str(stream_id)
        gateway = self.gateway_for(stream_id)
        self._stream_regions.pop(stream_id, None)
        gateway.post_message("destroy_stream", [stream_id])
