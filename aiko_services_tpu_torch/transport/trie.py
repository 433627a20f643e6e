# Topic trie: MQTT-wildcard-aware subscription index.
#
# Every broker publish used to fan out to EVERY client, and every
# client linearly scanned its whole subscription set per message
# (O(clients x patterns) matching per publish) -- the measured
# control-plane ceiling once stream counts reach the thousands.  This
# trie replaces the scan with one walk over the topic's levels:
# matching costs O(levels x branching) regardless of how many
# patterns are registered, and it is shared by the loopback broker
# (route each publish only to subscribed clients), the minimqtt
# broker's session routing, and the process message-handler table.
#
# Semantics contract: for every registered pattern,
# `value in trie.match(topic)` iff `topic_matches(pattern, topic)`
# (transport/base.py) -- including the edge cases the linear matcher
# defines: '#' matches the remainder INCLUDING zero levels ("a/#"
# matches "a"), '#' anywhere in a pattern terminates it ("a/#/b"
# behaves as "a/#"), '+' matches exactly one level including an empty
# one ("a/+" matches "a/"), and leading '/' introduces an empty first
# level.  tests/test_scaleout.py proves the equivalence over a
# generated corpus, bit for bit.
#
# Not thread-safe: callers (broker, process) hold their own lock
# around mutation and match -- matching never yields, so the critical
# section is a few dict lookups per topic level.

from __future__ import annotations

__all__ = ["TopicTrie"]


class _Node:
    __slots__ = ("children", "plus", "values", "hash_values")

    def __init__(self):
        self.children: dict[str, _Node] = {}
        self.plus: _Node | None = None
        # patterns terminating exactly at this level
        self.values: set = set()
        # patterns whose next level is '#' (match everything from
        # here, including zero further levels)
        self.hash_values: set = set()

    def empty(self) -> bool:
        return (not self.children and self.plus is None
                and not self.values and not self.hash_values)


class TopicTrie:
    """pattern -> set-of-values index with MQTT wildcard matching."""

    def __init__(self):
        self._root = _Node()
        self._pattern_count = 0

    def __len__(self) -> int:
        """Registered (pattern, value) pairs."""
        return self._pattern_count

    @staticmethod
    def _walk_levels(pattern: str):
        """The pattern's stored levels: everything past a '#' is
        unreachable in topic_matches (the '#' check short-circuits), so
        it is normalized away at insert time."""
        levels = pattern.split("/")
        if "#" in levels:
            levels = levels[:levels.index("#") + 1]
        return levels

    def add(self, pattern: str, value) -> None:
        node = self._root
        for level in self._walk_levels(pattern):
            if level == "#":
                if value not in node.hash_values:
                    node.hash_values.add(value)
                    self._pattern_count += 1
                return
            if level == "+":
                if node.plus is None:
                    node.plus = _Node()
                node = node.plus
            else:
                child = node.children.get(level)
                if child is None:
                    child = node.children[level] = _Node()
                node = child
        if value not in node.values:
            node.values.add(value)
            self._pattern_count += 1

    def discard(self, pattern: str, value) -> None:
        """Remove one (pattern, value) registration; prunes emptied
        branches so long-lived brokers don't accrete dead nodes."""
        path: list[tuple[_Node, str]] = []
        node = self._root
        levels = self._walk_levels(pattern)
        for level in levels:
            if level == "#":
                if value in node.hash_values:
                    node.hash_values.discard(value)
                    self._pattern_count -= 1
                break
            path.append((node, level))
            node = node.plus if level == "+" else node.children.get(level)
            if node is None:
                return
        else:
            if value in node.values:
                node.values.discard(value)
                self._pattern_count -= 1
        # prune: drop empty leaf nodes bottom-up
        for parent, level in reversed(path):
            child = parent.plus if level == "+" else parent.children.get(
                level)
            if child is None or not child.empty():
                break
            if level == "+":
                parent.plus = None
            else:
                del parent.children[level]

    def remove_value(self, value) -> None:
        """Remove `value` from EVERY registered pattern (a client
        detaching from the broker)."""
        self._remove_value(self._root, value)

    def _remove_value(self, node: _Node, value) -> None:
        if value in node.values:
            node.values.discard(value)
            self._pattern_count -= 1
        if value in node.hash_values:
            node.hash_values.discard(value)
            self._pattern_count -= 1
        for level in list(node.children):
            child = node.children[level]
            self._remove_value(child, value)
            if child.empty():
                del node.children[level]
        if node.plus is not None:
            self._remove_value(node.plus, value)
            if node.plus.empty():
                node.plus = None

    def match(self, topic: str) -> list:
        """Every value whose pattern matches `topic`, deduplicated
        (one value registered under several matching patterns appears
        once).  Order is unspecified -- callers needing determinism
        sort by their own sequence."""
        results = set(self._root.hash_values)
        current = [self._root]
        for level in topic.split("/"):
            following: list[_Node] = []
            for node in current:
                child = node.children.get(level)
                if child is not None:
                    following.append(child)
                if node.plus is not None:
                    following.append(node.plus)
            if not following:
                return list(results)
            for node in following:
                results.update(node.hash_values)
            current = following
        for node in current:
            results.update(node.values)
        return list(results)

    def matches(self, topic: str) -> bool:
        """True when ANY registered pattern matches `topic` -- the
        client-side fast path (a delivery gate needs the boolean, not
        the value set)."""
        if self._root.hash_values:
            return True
        current = [self._root]
        for level in topic.split("/"):
            following = []
            for node in current:
                child = node.children.get(level)
                if child is not None:
                    following.append(child)
                if node.plus is not None:
                    following.append(node.plus)
            if not following:
                return False
            for node in following:
                if node.hash_values:
                    return True
            current = following
        return any(node.values for node in current)
