"""SLO-constrained provisioning: invert the fleet model to size a deployment.

Everything else in the port predicts latency *given* a deployment; this
package searches deployments — minimum edge count, accelerator tier, and
shared bandwidth meeting a p99 budget for N clients at the decision
equilibrium — by monotone bisection over the batched exact tail, on the card.
"""

from .provision import ProvisionPlan, ProvisionSpace, provision

__all__ = [k for k in dir() if not k.startswith("_")]
