"""Public experiment API of the port: declarative specs, the sync-method
registry and the one trainer factory.

    from repro_torch.api import ExperimentSpec, MethodSpec, build_experiment

    spec = ExperimentSpec(method=MethodSpec(name="cocodc", local_steps=100))
    trainer = build_experiment(spec, device="cuda")
    trainer.run(eval_every=spec.run.eval_every)
"""
from repro_torch.api.build import (build_experiment, build_network,  # noqa: F401
                                   check_scope, mean_fragment_bytes,
                                   resolve_model)
from repro_torch.api.spec import (ExperimentSpec, MethodExtensions,  # noqa: F401
                                  MethodSpec, ModelRef, NetworkSpec, RunSpec,
                                  diff_specs)
from repro_torch.core.methods import (SyncMethod, get_method,  # noqa: F401
                                      register_method, registered_methods)
