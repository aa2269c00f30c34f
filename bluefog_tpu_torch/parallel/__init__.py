"""The rank context, the stacked-array op API, and mesh axes over virtual
ranks with the tensor-parallel and pipeline-parallel layers on them."""
