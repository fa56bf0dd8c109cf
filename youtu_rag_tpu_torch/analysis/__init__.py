"""Reports over what the port's agents record (the counterpart of the JAX
package's ``scripts/analysis/``)."""
