"""The rank context and the stacked-array op API."""
