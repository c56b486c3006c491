"""Normalized Mesos task-group status over the master's REST API.

The reference mesos backend registers a framework and watches task status
updates in-process (reference tracker/dmlc_tracker/mesos.py TASK_FINISHED/
TASK_FAILED handling); here `mesos-execute` owns the framework, so the
supervisor observes the same transitions through the master's `/tasks`
endpoint instead.

Usage: python3 -m dmlc_core_tpu_torch.tracker.mesos_status <master> <task-name>
Prints one word: PENDING | RUNNING | SUCCEEDED | FAILED. Exit 0 when the
master answered, nonzero on a transport error (CommandTask treats that as
a transient status error).

The port's own copy of ``dmlc_core_tpu/tracker/mesos_status.py`` (it imports nothing of
the JAX package): the same names, env variables, CLI flags and wire
bytes, so a worker of either package joins the other's tracker.
"""

import json
import sys
import urllib.request

_FAILED_STATES = frozenset((
    "TASK_FAILED", "TASK_KILLED", "TASK_LOST", "TASK_ERROR",
    "TASK_DROPPED", "TASK_GONE", "TASK_GONE_BY_OPERATOR",
))


def group_state(tasks, name: str) -> str:
    """Fold the instance states of task group `name` into one verdict:
    any failed instance fails the group; the group succeeds only when
    every instance finished."""
    states = []
    for t in tasks:
        if t.get("name") != name:
            continue
        s = t.get("state", "")
        if s in _FAILED_STATES:
            states.append("FAILED")
        elif s == "TASK_FINISHED":
            states.append("SUCCEEDED")
        else:
            states.append("RUNNING")
    if "FAILED" in states:
        return "FAILED"
    if states and all(s == "SUCCEEDED" for s in states):
        return "SUCCEEDED"
    return "RUNNING" if states else "PENDING"


def main() -> int:
    """CLI entry: print the folded group state and exit 0 when the master
    answered."""
    master, name = sys.argv[1], sys.argv[2]
    if not master.startswith("http"):
        master = "http://" + master
    try:
        with urllib.request.urlopen(master.rstrip("/") + "/tasks",
                                    timeout=10) as r:
            data = json.load(r)
    except Exception as e:  # transport error -> transient for the caller
        print(f"mesos master unreachable: {e}", file=sys.stderr)
        return 1
    print(group_state(data.get("tasks", []), name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
