"""Project-native developer tooling of the port: the AST invariant checker
(:mod:`tpusnap_torch.devtools.lint`, ``python -m tpusnap_torch lint``) and
the runtime lock-order watchdog (:mod:`tpusnap_torch.devtools.lockwatch`,
``TPUSNAP_LOCKCHECK=1``). Vendored from tpusnap/devtools.

Kept import-light on purpose: this package is imported from
``tpusnap_torch/__init__`` (lockcheck auto-install) before the heavy
torch-facing modules, and the lint engine must be runnable against a
source TREE without importing it.
"""
